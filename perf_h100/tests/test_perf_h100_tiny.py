"""Each configuration's CPU size (``tests/tiny/<config>.json``): every
configuration of ``BENCHMARK.json`` has one, its shrunk program loads the
shrunk plain reference's state, and a configuration without one fails with
the file's name."""

import os

import pytest

from conftest import TINY_DIR, shrink
from harness import core
from harness.weights import meta_model

MANIFEST = core.read_json(f"{core.ROOT}/BENCHMARK.json")
CONFIGS = [c["name"] for c in MANIFEST["configs"]]


def first_cell(config):
    return next(w["name"] for w in MANIFEST["workloads"] if w["config"] == config)


@pytest.mark.parametrize("config", CONFIGS)
def test_shrunk_program_and_reference_have_the_same_state(config):
    cell = shrink(core.Cell(MANIFEST, first_cell(config)))
    port = cell.kind.port_model(cell.config).state_dict()
    ref = meta_model(cell.reference.reference_model, cell.config).state_dict()
    assert list(port) == list(ref)
    assert {k: tuple(v.shape) for k, v in port.items()} == {k: tuple(v.shape)
                                                             for k, v in ref.items()}


def test_a_configuration_without_a_tiny_file_names_the_file():
    cell = core.Cell(MANIFEST, MANIFEST["workloads"][0]["name"])
    cell.workload = dict(cell.workload, config="no_such_config")
    with pytest.raises(FileNotFoundError, match="perf_h100/tests/tiny/no_such_config.json"):
        shrink(cell)


def test_every_configuration_has_a_tiny_file_that_builds_the_port():
    names = {f[:-len(".json")] for f in os.listdir(TINY_DIR) if f.endswith(".json")}
    assert set(CONFIGS) <= names
    for name in names:
        tiny = core.read_json(os.path.join(TINY_DIR, name + ".json"))
        if "program_factory" in tiny:
            assert tiny["program_factory"].split(".")[0] == "object_keypoints_tpu_torch"
