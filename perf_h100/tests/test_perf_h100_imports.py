"""Nothing the harness runs imports JAX or the JAX package, or reads bench.py
or benchmarks/: top-level module names compared whole."""

import ast
import os

from conftest import HERE
from harness import core


def imported_top_names(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            if ":" in node.value and node.value.split(":")[0].count(".") >= 1:
                names.add(node.value.split(".")[0])  # a factory path "pkg.mod:name"
    return names


def modules():
    for dirpath, dirnames, files in os.walk(HERE):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "tests")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = {}
    for path in modules():
        bad = sorted(imported_top_names(path) & set(core.FORBIDDEN) | (
            imported_top_names(path) & {"bench", "benchmarks"}))
        if bad:
            found[os.path.relpath(path, HERE)] = bad
    assert not found, found
    assert "object_keypoints_tpu_torch" not in core.FORBIDDEN  # a prefix is not a match


def test_the_guard_compares_whole_names():
    assert core.loaded_forbidden(["object_keypoints_tpu_torch.serving", "torch", "numpy"]) == []
    assert core.loaded_forbidden(["jax.numpy", "object_keypoints_tpu.models"]) == [
        "jax", "object_keypoints_tpu"]
    assert core.loaded_forbidden(["jaxtyping", "flaxen"]) == []


def test_config_factories_are_the_port():
    import json

    for name in os.listdir(os.path.join(HERE, "configs")):
        if name.endswith(".json"):
            cfg = json.load(open(os.path.join(HERE, "configs", name)))
            if "program_factory" in cfg:
                assert cfg["program_factory"].split(".")[0] == "object_keypoints_tpu_torch"
