"""Convert a reference torch checkpoint into a serving artifact.

    python -m object_keypoints_tpu_torch.cli.import_checkpoint model.ckpt \
        --out artifact --keypoints config/valve.json [--features 128]

The port of scripts/import_torch_checkpoint.py, with its flags. The
reference's pretrained backbone is a torch state_dict pickle (its
perception/models.py:69-78, ``./models/corner_net.pkl``); a Lightning
checkpoint carries the whole KeypointNet under ``state_dict``. The keys are
massaged as the JAX script does (the Lightning ``state_dict``, its
``model.`` prefix, ``backbone.`` put before a bare backbone's keys); the
port's KeypointNet already has the reference's names, so ``load_state_dict``
is the import, and a reference key the model lacks raises
``ValueError("unmapped reference keys: ...")`` as the JAX package's
``import_keypoint_net`` does. The artifact is ``serving.export.export_model``'s
(the JAX package's format); the CLI prints {"out", "imported_params"}.

A bare backbone has no heads. As in the JAX script, its import succeeds and
the artifact holds the backbone's parameters and statistics alone (config.json
names the heads' width all the same); ``imported_params`` counts the
backbone's. Neither package can serve that artifact: ``load_model`` raises on
the missing head keys. It is a store of the pretrained backbone, to start a
model's training from.
"""

import argparse
import json

from object_keypoints_tpu_torch.serving.export import architecture, export_model, model_from_config
from object_keypoints_tpu_torch.serving.weights import keypoint_net_variables


def read_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint", help=".pkl / .ckpt torch checkpoint")
    parser.add_argument("--out", required=True, help="Output artifact directory")
    parser.add_argument("--keypoints", required=True,
                        help="Keypoint topology JSON (config/valve.json)")
    parser.add_argument("--features", type=int, default=128)
    return parser.parse_args(argv)


def load_state_dict(path: str) -> dict:
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:  # Lightning checkpoint
        obj = obj["state_dict"]
        # Lightning prefixes module attrs with 'model.'
        obj = {k.removeprefix("model."): v for k, v in obj.items()}
    if not isinstance(obj, dict):
        obj = obj.state_dict()
    # bare backbone (net.model.module.hg) -> prefix like the full net
    if any(k.startswith("pre.") for k in obj):
        obj = {f"backbone.{k}": v for k, v in obj.items()}
    return obj


def import_keypoint_net(model, state_dict: dict, config: dict) -> dict:
    """Load ``state_dict`` into ``model`` and return the JAX-layout variables
    to write: the whole model's, or the backbone's alone where the state_dict
    has no heads."""
    loaded = {k: v for k, v in state_dict.items() if "num_batches_tracked" not in k}
    expected = {k for k in model.state_dict() if "num_batches_tracked" not in k}
    unmapped = sorted(set(loaded) - expected)
    if unmapped:
        raise ValueError(f"unmapped reference keys: {unmapped[:8]}"
                         f"{' ...' if len(unmapped) > 8 else ''}")
    missing = sorted(expected - set(loaded))
    bare = bool(missing) and all(not k.startswith("backbone.") for k in missing)
    if missing and not bare:
        raise KeyError(f"reference checkpoint lacks keys: {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    model.load_state_dict(loaded, strict=False)
    variables = keypoint_net_variables(model.state_dict(), **architecture(config))
    if bare:
        variables = {col: {"backbone": tree["backbone"]} for col, tree in variables.items()}
    return variables


def count_params(tree) -> int:
    return sum(count_params(v) if isinstance(v, dict) else int(v.size) for v in tree.values())


def main(argv=None):
    flags = read_args(argv)
    with open(flags.keypoints, "rt") as f:
        keypoint_config = json.load(f)["keypoint_config"]
    config = {
        "heatmaps_out": len(keypoint_config) + 1,
        "features": flags.features,
        "dropout": 0.0,
        "keypoint_config": keypoint_config,
    }
    variables = import_keypoint_net(model_from_config(config), load_state_dict(flags.checkpoint),
                                    config)
    export_model(flags.out, config, variables)
    result = {"out": flags.out, "imported_params": count_params(variables["params"])}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
