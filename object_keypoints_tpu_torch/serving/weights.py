"""JAX variables -> port state_dict.

The inverse of ``object_keypoints_tpu.serving.torch_import.import_keypoint_net``:
it walks the same name correspondence the other way, so a JAX KeypointNet's
``{"params", "batch_stats"}`` (nested dicts of numpy arrays, e.g. from an
exported artifact) load into the port's ``KeypointNet`` with ``strict=True``.

Layouts: a flax conv kernel (kH, kW, I[/g], O) becomes (O, I[/g], kH, kW);
a flax ConvTranspose kernel (kH, kW, I, O) is spatially flipped against
torch's and becomes (I, O, kH, kW) un-flipped; BatchNorm scale/bias/mean/var
become weight/bias/running_mean/running_var. The values are copied
bit for bit.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch


def conv_weight(kernel) -> np.ndarray:
    """(kH, kW, I, O) -> (O, I, kH, kW)."""
    return np.asarray(kernel).transpose(3, 2, 0, 1)


def conv_transpose_weight(kernel) -> np.ndarray:
    """Flipped (kH, kW, I, O) -> (I, O, kH, kW)."""
    return np.asarray(kernel)[::-1, ::-1].transpose(2, 3, 0, 1)


class _Exporter:
    def __init__(self, variables: Mapping):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.sd: Dict[str, np.ndarray] = {}

    @staticmethod
    def _get(tree: Mapping, path: Sequence[str]):
        for p in path:
            tree = tree[p]
        return tree

    def conv(self, key: str, fp: Sequence[str], bias_key: str = None):
        node = self._get(self.params, fp)
        self.sd[key] = conv_weight(node["kernel"])
        if bias_key is not None:
            self.sd[bias_key] = np.asarray(node["bias"])

    def conv_t(self, tp: str, fp: Sequence[str]):
        node = self._get(self.params, fp)
        self.sd[f"{tp}.weight"] = conv_transpose_weight(node["kernel"])
        self.sd[f"{tp}.bias"] = np.asarray(node["bias"])

    def bn(self, tp: str, fp: Sequence[str]):
        p, s = self._get(self.params, fp), self._get(self.stats, fp)
        self.sd[f"{tp}.weight"] = np.asarray(p["scale"])
        self.sd[f"{tp}.bias"] = np.asarray(p["bias"])
        self.sd[f"{tp}.running_mean"] = np.asarray(s["mean"])
        self.sd[f"{tp}.running_var"] = np.asarray(s["var"])
        self.sd[f"{tp}.num_batches_tracked"] = np.zeros((), np.int64)

    def convolution(self, tp: str, fp):
        self.conv(f"{tp}.conv.weight", (*fp, "Conv_0"))
        self.bn(f"{tp}.bn", (*fp, "BatchNorm_0"))

    def residual(self, tp: str, fp, has_skip: bool):
        self.conv(f"{tp}.conv1.weight", (*fp, "Conv_0"))
        self.bn(f"{tp}.bn1", (*fp, "BatchNorm_0"))
        self.conv(f"{tp}.conv2.weight", (*fp, "Conv_1"))
        self.bn(f"{tp}.bn2", (*fp, "BatchNorm_1"))
        if has_skip:
            self.conv(f"{tp}.skip.0.weight", (*fp, "Conv_2"))
            self.bn(f"{tp}.skip.1", (*fp, "BatchNorm_2"))

    def fire(self, tp: str, fp):
        self.conv(f"{tp}.conv1.weight", (*fp, "Conv_0"))
        self.bn(f"{tp}.bn1", (*fp, "BatchNorm_0"))
        self.conv(f"{tp}.conv_1x1.weight", (*fp, "Conv_1"))
        self.conv(f"{tp}.conv_3x3.weight", (*fp, "Conv_2"))
        self.bn(f"{tp}.bn2", (*fp, "BatchNorm_1"))

    def merge_mod(self, tp: str, fp):
        self.conv(f"{tp}.0.weight", (*fp, "Conv_0"))
        self.bn(f"{tp}.1", (*fp, "BatchNorm_0"))

    def pred_module(self, tp: str, fp):
        self.convolution(f"{tp}.0", (*fp, "conv0"))
        self.convolution(f"{tp}.1", (*fp, "conv1"))
        self.conv(f"{tp}.2.weight", (*fp, "conv_out"), bias_key=f"{tp}.2.bias")

    def hg_module(self, tp: str, fp, level: int, mods):
        curr_mod, next_mod = mods[0], mods[1]
        for i in range(curr_mod):
            self.fire(f"{tp}.up1.{i}", (*fp, f"up1_{i}"))
            self.fire(f"{tp}.low1.{i}", (*fp, f"low1_{i}"))
        if level > 1:
            self.hg_module(f"{tp}.low2", (*fp, "low2"), level - 1, mods[1:])
        else:
            for i in range(next_mod):
                self.fire(f"{tp}.low2.{i}", (*fp, f"low2_{i}"))
        for i in range(curr_mod):
            self.fire(f"{tp}.low3.{i}", (*fp, f"low3_{i}"))
        self.conv_t(f"{tp}.up2", (*fp, "up2"))


def keypoint_net_state_dict(variables: Mapping, stacks: int = 2, levels: int = 4,
                            mods: Sequence[int] = (2, 2, 2, 2, 4)) -> Dict[str, torch.Tensor]:
    """JAX KeypointNet variables -> a state_dict for the port's KeypointNet."""
    ex = _Exporter(variables)
    ex.convolution("backbone.pre.0", ("backbone", "pre_conv"))
    ex.residual("backbone.pre.1", ("backbone", "pre_res1"), has_skip=True)
    ex.residual("backbone.pre.2", ("backbone", "pre_res2"), has_skip=True)
    for s in range(stacks):
        ex.hg_module(f"backbone.hgs.{s}", ("backbone", f"hg_{s}"), levels, tuple(mods))
        ex.convolution(f"backbone.cnvs.{s}", ("backbone", f"cnv_{s}"))
        if s < stacks - 1:
            ex.residual(f"backbone.inters.{s}", ("backbone", f"inter_res_{s}"), has_skip=False)
            ex.merge_mod(f"backbone.inters_.{s}", ("backbone", f"inter_merge_{s}"))
            ex.merge_mod(f"backbone.cnvs_.{s}", ("backbone", f"cnv_merge_{s}"))
    for head in ("heatmap", "depth", "center"):
        for s in range(stacks):
            ex.pred_module(f"{head}_head.output_head{s + 1}", (f"{head}_head_{s}",))
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in ex.sd.items()}
