"""Mean device milliseconds of one call's forward (``make_inference_fn``'s
``infer``), from CUDA events around it in every call of the traced window."""


def read(run):
    ms = run.spans.get("forward")
    return sum(ms) / len(ms) if ms else None
