"""Build the package's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds). The
library lands in ``object_keypoints_tpu_torch/_build/`` under a name keyed on
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the cached file. ``ptxas -v`` output (registers, shared
memory, spills per kernel) is kept beside it as ``<name>.log``.

Nothing here falls back: without ``nvcc``, or when it fails, the call raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, else the one on ``PATH``."""
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and os.access(os.path.join(cuda_home, "bin", "nvcc"), os.X_OK):
        return os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels of object_keypoints_tpu_torch are built from csrc/ at first use"
        )
    return found


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"okt_kernels_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile ``csrc/*.cu`` unless the keyed library already exists."""
    out = library_path()
    if out.exists():
        return out
    sources = [str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]
    if not sources:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), *sources],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stderr + proc.stdout)
    os.replace(tmp, out)  # atomic: a concurrent build in another process sees all or nothing
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C signatures."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.okt_stem_conv_fp32, lib.okt_stem_conv_bf16):
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    lib.okt_quantize_int8.argtypes = [p, i, p, ctypes.c_float, p, ctypes.c_longlong,
                                      ctypes.c_longlong, p]
    lib.okt_quantize_int8.restype = ctypes.c_int
    ll = ctypes.c_longlong
    lib.okt_corner_pool_fwd.argtypes = [p, p, i, ll, i, i, i, i, i, p]
    lib.okt_corner_pool_bwd.argtypes = [p, p, p, i, ll, i, i, i, i, i, p]
    for fn in (lib.okt_corner_pool_fwd, lib.okt_corner_pool_bwd):
        fn.restype = ctypes.c_int
    return lib
