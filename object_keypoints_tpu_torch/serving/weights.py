"""JAX variables <-> port state_dict.

One walk over a model records which flax leaf each port state_dict entry
is, and both directions follow it. ``keypoint_net_state_dict`` is the
inverse of ``object_keypoints_tpu.serving.torch_import.import_keypoint_net``:
a JAX KeypointNet's ``{"params", "batch_stats"}`` (nested dicts of numpy
arrays, e.g. from an exported artifact) load into the port's
``KeypointNet`` with ``strict=True``. ``keypoint_net_variables`` goes back,
so the port can write an artifact the JAX package reads.
``cornernet_state_dict`` and ``cornernet_variables`` do the same for the
CornerNet detectors (the inverse of ``import_cornernet{,_squeeze,_saccade}``,
and of any ``models.cornernet.CornerNetModel`` configuration).

Layouts: a flax conv kernel (kH, kW, I[/g], O) becomes (O, I[/g], kH, kW);
a flax ConvTranspose kernel (kH, kW, I, O) is spatially flipped against
torch's and becomes (I, O, kH, kW) un-flipped; BatchNorm scale/bias/mean/var
become weight/bias/running_mean/running_var. The values are copied bit for
bit both ways.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Union

import numpy as np
import torch

from object_keypoints_tpu_torch.models.cornernet import ARCHS


def conv_weight(kernel) -> np.ndarray:
    """(kH, kW, I, O) -> (O, I, kH, kW)."""
    return np.asarray(kernel).transpose(3, 2, 0, 1)


def conv_transpose_weight(kernel) -> np.ndarray:
    """Flipped (kH, kW, I, O) -> (I, O, kH, kW)."""
    return np.asarray(kernel)[::-1, ::-1].transpose(2, 3, 0, 1)


def conv_kernel(weight) -> np.ndarray:
    """(O, I, kH, kW) -> (kH, kW, I, O), the inverse of ``conv_weight``."""
    return np.asarray(weight).transpose(2, 3, 1, 0)


def conv_transpose_kernel(weight) -> np.ndarray:
    """(I, O, kH, kW) -> flipped (kH, kW, I, O), the inverse of
    ``conv_transpose_weight``."""
    return np.asarray(weight).transpose(2, 3, 0, 1)[::-1, ::-1]


# leaf kind -> (flax -> port, port -> flax)
_LAYOUTS = {
    "conv": (conv_weight, conv_kernel),
    "conv_t": (conv_transpose_weight, conv_transpose_kernel),
    "same": (np.asarray, np.asarray),
}


class _NameMap:
    """Walks the model, recording each state_dict entry as (port key, flax
    collection or None for num_batches_tracked, flax path, layout kind)."""

    def __init__(self):
        self.entries = []

    def _add(self, key, collection, path, kind="same"):
        self.entries.append((key, collection, tuple(path), kind))

    def conv(self, key: str, fp: Sequence[str], bias_key: str = None):
        self._add(key, "params", (*fp, "kernel"), "conv")
        if bias_key is not None:
            self._add(bias_key, "params", (*fp, "bias"))

    def conv_t(self, tp: str, fp: Sequence[str]):
        self._add(f"{tp}.weight", "params", (*fp, "kernel"), "conv_t")
        self._add(f"{tp}.bias", "params", (*fp, "bias"))

    def bn(self, tp: str, fp: Sequence[str]):
        self._add(f"{tp}.weight", "params", (*fp, "scale"))
        self._add(f"{tp}.bias", "params", (*fp, "bias"))
        self._add(f"{tp}.running_mean", "batch_stats", (*fp, "mean"))
        self._add(f"{tp}.running_var", "batch_stats", (*fp, "var"))
        self._add(f"{tp}.num_batches_tracked", None, ())

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

    def res_hg_module(self, tp: str, fp, level: int, dims, mods, in_dim: int):
        """The residual hourglass: stride-2 residual down, a parameterless
        nearest unpool; a residual has its projection skip where its stride
        or width changes."""
        curr_dim, next_dim = dims[0], dims[1]
        curr_mod, next_mod = mods[0], mods[1]
        for i in range(curr_mod):
            self.residual(f"{tp}.up1.{i}", (*fp, f"up1_{i}"), i == 0 and in_dim != curr_dim)
        self.residual(f"{tp}.low1.0", (*fp, "low1_0"), has_skip=True)
        for i in range(1, curr_mod):
            self.residual(f"{tp}.low1.{i}", (*fp, f"low1_{i}"), has_skip=False)
        if level > 1:
            self.res_hg_module(f"{tp}.low2", (*fp, "low2"), level - 1, dims[1:], mods[1:],
                               next_dim)
        else:
            for i in range(next_mod):
                self.residual(f"{tp}.low2.{i}", (*fp, f"low2_{i}"), has_skip=False)
        for i in range(curr_mod):
            self.residual(f"{tp}.low3.{i}", (*fp, f"low3_{i}"),
                          i == curr_mod - 1 and next_dim != curr_dim)

    def corner_pool_block(self, tp: str, fp):
        self.convolution(f"{tp}.p1_conv1", (*fp, "p1_conv1"))
        self.convolution(f"{tp}.p2_conv1", (*fp, "p2_conv1"))
        self.conv(f"{tp}.p_conv1.weight", (*fp, "p_conv1"))
        self.bn(f"{tp}.p_bn1", (*fp, "p_bn1"))
        self.conv(f"{tp}.conv1.weight", (*fp, "conv1"))
        self.bn(f"{tp}.bn1", (*fp, "bn1"))
        self.convolution(f"{tp}.conv2", (*fp, "conv2"))

    def det_pred_module(self, tp: str, fp):
        """conv with bias (no BN) + 1x1 conv with bias."""
        self.conv(f"{tp}.0.conv.weight", (*fp, "conv0", "Conv_0"), bias_key=f"{tp}.0.conv.bias")
        self.conv(f"{tp}.1.weight", (*fp, "conv_out"), bias_key=f"{tp}.1.bias")

    def cornernet(self, arch: Mapping):
        """A CornerNetModel of configuration ``arch`` (``models.cornernet.ARCHS``)."""
        stacks, levels = arch["stacks"], arch["levels"]
        dims, mods = tuple(arch["dims"]), tuple(arch["mods"])
        cnv_dim = arch.get("cnv_dim", 256)
        self.convolution("hg.pre.0", ("pre_conv",))
        for i in range(arch.get("stem_residuals", 2)):
            self.residual(f"hg.pre.{i + 1}", (f"pre_res{i + 1}",), has_skip=True)
        for s in range(stacks):
            if arch.get("hourglass", "fire") == "fire":
                self.hg_module(f"hg.hgs.{s}", (f"hg_{s}",), levels, mods)
            else:
                self.res_hg_module(f"hg.hgs.{s}", (f"hg_{s}",), levels, dims, mods,
                                   256 if s == 0 else cnv_dim)
            self.convolution(f"hg.cnvs.{s}", (f"cnv_{s}",))
            if s < stacks - 1:
                self.residual(f"hg.inters.{s}", (f"inter_res_{s}",), has_skip=False)
                self.merge_mod(f"hg.inters_.{s}", (f"inter_merge_{s}",))
                self.merge_mod(f"hg.cnvs_.{s}", (f"cnv_merge_{s}",))
            for side in ("tl", "br"):
                self.corner_pool_block(f"{side}_modules.{s}", (f"{side}_mod_{s}",))
                for head, name in (("heats", "heat"), ("tags", "tag"), ("offs", "off")):
                    self.det_pred_module(f"{side}_{head}.{s}", (f"{side}_{name}_{s}",))
            if arch.get("with_attention", False):
                for i in range(levels):
                    self.det_pred_module(f"att_modules.{s}.{i}", (f"att_{s}_{i}",))
        return self

    def keypoint_net(self, stacks: int, levels: int, mods: Sequence[int]):
        self.convolution("backbone.pre.0", ("backbone", "pre_conv"))
        self.residual("backbone.pre.1", ("backbone", "pre_res1"), has_skip=True)
        self.residual("backbone.pre.2", ("backbone", "pre_res2"), has_skip=True)
        for s in range(stacks):
            self.hg_module(f"backbone.hgs.{s}", ("backbone", f"hg_{s}"), levels, tuple(mods))
            self.convolution(f"backbone.cnvs.{s}", ("backbone", f"cnv_{s}"))
            if s < stacks - 1:
                self.residual(f"backbone.inters.{s}", ("backbone", f"inter_res_{s}"),
                              has_skip=False)
                self.merge_mod(f"backbone.inters_.{s}", ("backbone", f"inter_merge_{s}"))
                self.merge_mod(f"backbone.cnvs_.{s}", ("backbone", f"cnv_merge_{s}"))
        for head in ("heatmap", "depth", "center"):
            for s in range(stacks):
                self.pred_module(f"{head}_head.output_head{s + 1}", (f"{head}_head_{s}",))
        return self


class _Exporter(_NameMap):
    """The walk over JAX ``variables``; ``sd`` holds the port state_dict
    (numpy) of every entry walked so far."""

    def __init__(self, variables: Mapping):
        super().__init__()
        self.variables = {"params": variables["params"],
                          "batch_stats": variables.get("batch_stats", {})}

    @property
    def sd(self) -> Dict[str, np.ndarray]:
        out = {}
        for key, collection, path, kind in self.entries:
            if collection is None:
                out[key] = np.zeros((), np.int64)
                continue
            node = self.variables[collection]
            for p in path:
                node = node[p]
            out[key] = _LAYOUTS[kind][0](node)
        return out


def conv_module_paths(stacks: int = 2, levels: int = 4,
                      mods: Sequence[int] = (2, 2, 2, 2, 4)) -> Dict[str, tuple]:
    """Port module name -> (flax module path, "conv" or "conv_t") of every
    convolution of the KeypointNet, in the walk's order: the walk's kernel
    entries without their trailing ``weight`` / ``kernel``."""
    entries = _NameMap().keypoint_net(stacks, levels, mods).entries
    return {key[:-len(".weight")]: ("/".join(path[:-1]), kind)
            for key, _, path, kind in entries if kind in ("conv", "conv_t")}


def keypoint_net_param_shapes(state_dict: Mapping, stacks: int = 2, levels: int = 4,
                              mods: Sequence[int] = (2, 2, 2, 2, 4)) -> Dict[tuple, tuple]:
    """flax params path -> flax shape of every parameter of a port
    KeypointNet ``state_dict``, in the walk's order: a conv weight (O, I,
    kH, kW) is the kernel (kH, kW, I, O), a ConvTranspose weight (I, O, kH,
    kW) the kernel (kH, kW, I, O)."""
    order = {"conv": (2, 3, 1, 0), "conv_t": (2, 3, 0, 1)}
    out = {}
    for key, collection, path, kind in _NameMap().keypoint_net(stacks, levels, mods).entries:
        if collection == "params":
            shape = tuple(state_dict[key].shape)
            out[path] = tuple(shape[i] for i in order[kind]) if kind in order else shape
    return out


def keypoint_net_state_dict(variables: Mapping, stacks: int = 2, levels: int = 4,
                            mods: Sequence[int] = (2, 2, 2, 2, 4)) -> Dict[str, torch.Tensor]:
    """JAX KeypointNet variables -> a state_dict for the port's KeypointNet."""
    sd = _Exporter(variables).keypoint_net(stacks, levels, mods).sd
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def keypoint_net_variables(state_dict: Mapping, stacks: int = 2, levels: int = 4,
                           mods: Sequence[int] = (2, 2, 2, 2, 4)) -> dict:
    """A port KeypointNet state_dict -> JAX ``{"params", "batch_stats"}``,
    nested dicts of C-ordered float32 numpy arrays. Raises on a missing or
    unexpected key."""
    return _variables(state_dict, _NameMap().keypoint_net(stacks, levels, mods), "KeypointNet")


def _arch(arch: Union[str, Mapping]) -> Mapping:
    return ARCHS[arch] if isinstance(arch, str) else arch


def cornernet_state_dict(variables: Mapping, arch: Union[str, Mapping]) -> Dict[str, torch.Tensor]:
    """JAX CornerNetModel variables -> a state_dict for the port's
    ``CornerNetModel``; ``arch`` is a name of ``models.cornernet.ARCHS`` or a
    configuration (``tiny_arch(...)``)."""
    sd = _Exporter(variables).cornernet(_arch(arch)).sd
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def cornernet_variables(state_dict: Mapping, arch: Union[str, Mapping]) -> dict:
    """A port CornerNetModel state_dict -> JAX ``{"params", "batch_stats"}``."""
    return _variables(state_dict, _NameMap().cornernet(_arch(arch)), "CornerNetModel")


def _variables(state_dict: Mapping, walk: _NameMap, what: str) -> dict:
    entries = walk.entries
    expected = {key for key, *_ in entries}
    if set(state_dict) != expected:
        raise KeyError(f"state_dict keys differ from the {what}'s: missing "
                       f"{sorted(expected - set(state_dict))[:5]}, unexpected "
                       f"{sorted(set(state_dict) - expected)[:5]}")
    variables = {"params": {}, "batch_stats": {}}
    for key, collection, path, kind in entries:
        if collection is None:
            continue
        value = state_dict[key]
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        node = variables[collection]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(_LAYOUTS[kind][1](value), dtype=np.float32)
    return variables
