"""Mean device milliseconds of one call's object decode
(``decode_objects_batch``), from CUDA events around it in every call of the
traced window."""


def read(run):
    ms = run.spans.get("decode")
    return sum(ms) / len(ms) if ms else None
