"""``ops._build`` on the CPU with a stand-in ``nvcc``: one call compiles
every ``csrc/*.cu`` into the keyed library, a built library is loaded as it
is, and a failing build raises and leaves nothing but what was there."""

import types

import pytest

pytest.importorskip("torch")

from object_keypoints_tpu_torch.ops import _build  # noqa: E402

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{calls}"
case "$*" in *{fail}*) echo "{fail}(1): error: broken" >&2; exit 2;; esac
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
echo "ptxas info    : built $out" >&2
: > "$out"
"""


@pytest.fixture
def fake(monkeypatch, tmp_path):
    """Two sources and a stand-in nvcc that records its calls and fails on
    any call naming ``fail`` (``fake.write(fail)``)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a")
    (csrc / "b.cu").write_text("// b")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    (tmp_path / "cuda" / "bin").mkdir(parents=True)

    def write(fail="no-such-name"):
        nvcc = tmp_path / "cuda" / "bin" / "nvcc"
        nvcc.write_text(FAKE_NVCC.format(calls=tmp_path / "calls", fail=fail))
        nvcc.chmod(0o755)

    write()
    return types.SimpleNamespace(write=write, calls=tmp_path / "calls", csrc=csrc,
                                 build_dir=tmp_path / "_build")


def _calls(fake):
    return fake.calls.read_text().splitlines() if fake.calls.exists() else []


def test_one_nvcc_call_builds_every_source(fake):
    lib = _build.build()
    assert lib.exists() and lib == _build.library_path()
    (call,) = _calls(fake)
    assert call.split()[-2:] == [str(fake.csrc / "a.cu"), str(fake.csrc / "b.cu")]
    assert "-shared" in call and "-Xptxas -v" in call and "arch=compute_90a,code=sm_90a" in call
    assert sorted(p.name for p in fake.build_dir.iterdir()) == sorted(
        [lib.name, lib.with_suffix(".log").name])
    assert "ptxas info" in lib.with_suffix(".log").read_text()


def test_a_built_library_is_loaded_as_it_is(fake):
    first = _build.build()
    n = len(_calls(fake))
    assert _build.build() == first and len(_calls(fake)) == n


def test_an_edited_source_builds_another_library(fake):
    first = _build.build()
    (fake.csrc / "b.cu").write_text("// b, edited")
    second = _build.build()
    assert second != first and second.exists() and len(_calls(fake)) == 2


def test_a_failing_build_raises_and_leaves_nothing(fake):
    fake.write("b.cu")
    with pytest.raises(RuntimeError, match="error: broken"):
        _build.build()
    assert list(fake.build_dir.iterdir()) == []
