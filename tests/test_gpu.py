"""Card-only checks (marker ``gpu``): each device kernel at real widths
against its plain reference.  They skip without a GPU; on the card run
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` (one process, no -n).
"""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("shape", ["read_align", "placement"])
def test_cuda_dp_bitwise_equals_scan(gpu, shape):
    import dp_kernel_bench as dkb
    si = [s[0] for s in dkb.SHAPES].index(shape)
    _, W, P, Lq, Lt, ql, tl = dkb.SHAPES[si]
    case = dkb.dp_case(W, P, Lq, Lt, ql, tl, seed=31 + si)
    assert dkb.check(case, n_oracle=1)["bitwise_equal_to_scan"]


@pytest.mark.parametrize("mode", ["global", "qglocal"])
def test_cuda_dp_other_modes(gpu, mode):
    from falcon_unzip_tpu.ops.banded_align import banded_align_batch
    from falcon_unzip_tpu.ops.cuda_align import cuda_banded_align
    import dp_kernel_bench as dkb
    case = dkb.dp_case(128, 64, 1024, 1536, 900, 1000, seed=41)
    args = dkb._args(case)
    kw = dict(W=128, Lt=case["Lt"], G=case["G"], mode=mode)
    ref = banded_align_batch(*args, **kw)
    got = cuda_banded_align(*args, **kw)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))


def test_block_votes_exact(gpu):
    import chip_smoke
    chip_smoke.check_votes()


def test_arrow_splice_at_len_cap(gpu):
    import chip_smoke
    chip_smoke.check_arrow()
