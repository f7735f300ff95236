"""The CUDA banded DP's Python side, on the CPU: choice of path by
platform, the guard padding the kernel relies on, the result layout, and
no quiet fallback.  The kernel itself runs only on the card
(tests/test_gpu.py)."""
import functools
import os

import jax
import numpy as np
import pytest

from falcon_unzip_tpu.ops import banded_align as ba
from falcon_unzip_tpu.ops import cuda_align as ca


def test_platform_picks_the_dp():
    assert ba.dp_for_platform("gpu") is ca.cuda_banded_align
    assert ba.dp_for_platform("cpu") is ba.banded_align_batch
    assert ba.BandedAligner(W=256)._dp is ba.banded_align_batch


@pytest.mark.parametrize("W", [96, 1024, 48])
def test_unsupported_width_raises(W):
    with pytest.raises(ValueError):
        ca.check_width(W)


@pytest.mark.parametrize("Lq,Lt,W", [
    (4096, 4608, 256), (4096, 4608, 512), (256, 768, 128), (512, 256, 64),
    (1024, 1024, 32), (8192, 9216, 512)])
def test_guard_padding_covers_the_band(Lq, Lt, W):
    """prepare_batch's rows hold every index the kernel reads (the same
    inequalities the FFI handler checks before launch), at the full and
    at every 1024-quantized truncated Dmax."""
    q = np.zeros((2, Lq), np.int8)
    t = np.zeros((2, Lt), np.int8)
    qg, trg, G = ba.prepare_batch(q, t, W)
    LQG, LTG = qg.shape[1], trg.shape[1]
    assert LQG % 16 == 0 and LTG % 16 == 0
    assert G + Lt + W <= LTG
    Dfull = Lq + Lt + 1
    for Dmax in sorted({Dfull, *range(1024, Dfull, 1024)}):
        lo_last = ba.band_lo(Dmax - 1, W)
        assert lo_last + W <= LQG
        assert G + Lt - (Dmax - 1) + lo_last >= 0


@pytest.mark.parametrize("W,mode", [(256, "tglocal"), (128, "global"),
                                    (512, "qglocal")])
def test_ffi_result_layout_matches_scan(W, mode):
    """Same result names, shapes and dtypes as banded_align_batch,
    including the (Dmax, P, W) int8 backpointers traceback_batch reads."""
    P, Lq, Lt = 8, 512, 768
    qg, trg, G = ba.prepare_batch(np.zeros((P, Lq), np.int8),
                                  np.zeros((P, Lt), np.int8), W)
    Dmax, lo = ba.build_schedule(Lq, Lt, W)
    n = np.full(P, 500, np.int32)
    m = np.full(P, 700, np.int32)
    want = jax.eval_shape(functools.partial(
        ba.banded_align_batch, W=W, Lt=Lt, G=G, mode=mode), qg, trg, n, m,
        lo)
    got = jax.eval_shape(functools.partial(
        ca._ffi_banded_dp, W=W, Lt=Lt, G=G, Dmax=Dmax, mode=mode), qg, trg,
        n, m)
    assert got == want
    assert got["bp"].shape == (Dmax, P, W)


def test_ffi_call_does_not_lower_on_cpu():
    """The kernel is registered for CUDA only: on another platform the
    call fails instead of falling back."""
    P, Lq, Lt, W = 2, 256, 512, 64
    qg, trg, G = ba.prepare_batch(np.zeros((P, Lq), np.int8),
                                  np.zeros((P, Lt), np.int8), W)
    with pytest.raises(Exception):
        ca._ffi_banded_dp.lower(qg, trg, np.ones(P, np.int32),
                                np.ones(P, np.int32), W=W, Lt=Lt, G=G,
                                Dmax=Lq + Lt + 1, mode="global").compile()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(ca, "_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        ca.build()


def test_library_is_keyed_by_source_in_ignored_dir():
    lib = ca.library_path()
    assert lib.startswith(ca._BUILD_DIR)
    assert lib == ca.library_path()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, ".gitignore")) as fh:
        assert "falcon_unzip_tpu/native/build/" in fh.read().split()
