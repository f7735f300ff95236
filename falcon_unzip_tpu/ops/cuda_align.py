"""Banded edit-distance DP as a CUDA kernel for Hopper, through ``jax.ffi``.

The kernel (``native/src/banded_dp.cu``) computes exactly what
``ops.banded_align.banded_align_batch`` computes — distances, end cells
and the int8 ``(Dmax, P, W)`` backpointer tensor, bit for bit — but runs
the whole antidiagonal loop inside one launch with the band in registers,
where the XLA scan pays at least one kernel launch per antidiagonal.

The shared library is built from the repository's source with ``nvcc``
on first use, into ``native/build/`` (git-ignored), under a name keyed by
the source's hash; ``python -m falcon_unzip_tpu.ops.cuda_align`` builds
it ahead of time.  A failed build or launch raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SRC = os.path.join(_NATIVE_DIR, "src", "banded_dp.cu")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_TARGET = "falcon_banded_dp"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")

WIDTHS = (32, 64, 128, 256, 512)    # W = 32 lanes x {1, 2, 4, 8, 16} cells
MODES = {"global": 0, "qglocal": 1, "tglocal": 2}


def check_width(W: int) -> None:
    if W not in WIDTHS:
        raise ValueError(f"the CUDA banded DP takes band widths {WIDTHS}, "
                         f"not {W}")


def nvcc_path() -> str:
    """nvcc from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA banded DP cannot be built")


def library_path() -> str:
    with open(_SRC, "rb") as fh:
        h = hashlib.sha256(fh.read() + " ".join(_NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libbanded_dp-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the kernel library if this source has no build yet."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    nvcc = nvcc_path()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *_NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed building the CUDA banded DP:\n"
                               + proc.stderr[-4000:])
        os.replace(tmp, lib)     # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.cache
def register() -> ctypes.CDLL:
    """Build (if needed), load and register the FFI target, once."""
    lib = ctypes.CDLL(build())
    jax.ffi.register_ffi_target(_TARGET, jax.ffi.pycapsule(lib.BandedDp),
                                platform="CUDA")
    return lib


@functools.partial(jax.jit, static_argnames=("W", "Lt", "G", "Dmax", "mode"))
def _ffi_banded_dp(qg, trg, n, m, *, W: int, Lt: int, G: int, Dmax: int,
                   mode: str):
    P = qg.shape[0]
    i32 = jax.ShapeDtypeStruct((P,), jnp.int32)
    dist, end_i, end_j, bp = jax.ffi.ffi_call(
        _TARGET, (i32, i32, i32, jax.ShapeDtypeStruct((Dmax, P, W), jnp.int8))
    )(qg.astype(jnp.int8), trg.astype(jnp.int8), n.astype(jnp.int32),
      m.astype(jnp.int32), Lt=np.int64(Lt), G=np.int64(G),
      mode=np.int64(MODES[mode]))
    return {"dist": dist, "end_i": end_i, "end_j": end_j, "bp": bp}


def cuda_banded_align(qg, trg, n, m, lo_arr, *, W: int, Lt: int, G: int,
                      mode: str = "global", want_bp: bool = True):
    """Drop-in for ``banded_align_batch`` on the GPU (same arguments and
    results; the schedule ``lo_arr`` fixes Dmax, the kernel recomputes
    band_lo itself)."""
    check_width(W)
    register()
    res = _ffi_banded_dp(qg, trg, n, m, W=W, Lt=Lt, G=G,
                         Dmax=int(lo_arr.shape[0]), mode=mode)
    if not want_bp:
        res.pop("bp")
    return res


if __name__ == "__main__":
    print(build())
