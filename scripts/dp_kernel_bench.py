"""Banded edit DP on the GPU: the CUDA kernel against the XLA scan.

At the read-alignment shape (query bucket 4096, target bucket 4608, band
256, 256 pairs, tglocal) and the haplotig-placement shape (band 512, 64
pairs), this checks that ``cuda_banded_align`` is bit-equal to
``banded_align_batch`` (dist, end_i, end_j and the whole backpointer
tensor), checks a few pairs against ``oracle.align.banded_dp``, prints
each DP program's ``memory_analysis()``, and times DP alone and DP +
traceback, alternating XLA, kernel, kernel, XLA.  Prints one JSON line.

  python scripts/dp_kernel_bench.py [--reps N]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# (name, W, P, query bucket, target bucket, query length, target length)
SHAPES = (
    ("read_align", 256, 256, 4096, 4608, 2200, 2300),
    ("placement", 512, 64, 4096, 4608, 4096, 4205),
)
MODE = "tglocal"


def dp_case(W, P, Lq, Lt, q_len, t_len, seed, err=0.03):
    """P pairs: a random target window and a 3%-error read of its middle,
    PAD-padded to the (Lq, Lt) buckets, with the dispatcher's Dmax cut."""
    from falcon_unzip_tpu.ops.banded_align import build_schedule, prepare_batch
    from falcon_unzip_tpu.seq import PAD
    from falcon_unzip_tpu.utils.simulate import mutate_read, random_genome
    rng = np.random.default_rng(seed)
    q = np.full((P, Lq), PAD, np.int8)
    t = np.full((P, Lt), PAD, np.int8)
    n = np.zeros(P, np.int32)
    m = np.zeros(P, np.int32)
    for p in range(P):
        tt = random_genome(t_len, seed * 100_003 + p)
        o = (t_len - q_len) // 2
        qq = mutate_read(tt[o:o + q_len], err, rng)[:Lq]
        q[p, :len(qq)], t[p, :t_len] = qq, tt
        n[p], m[p] = len(qq), t_len
    Dmax, lo = build_schedule(Lq, Lt, W)
    Dmax = min(Dmax, -(-(int((n + m).max()) + 1) // 1024) * 1024)
    qg, trg, G = prepare_batch(q, t, W)
    return {"q": q, "t": t, "n": n, "m": m, "qg": qg, "trg": trg, "G": G,
            "lo": lo[:Dmax], "Lt": Lt, "W": W}


def _args(case):
    import jax.numpy as jnp
    return (jnp.asarray(case["qg"]), jnp.asarray(case["trg"]),
            jnp.asarray(case["n"]), jnp.asarray(case["m"]),
            jnp.asarray(case["lo"]))


def run(impl, case, traceback: bool):
    """One DP (+ traceback) call, finished on the device."""
    import jax
    from falcon_unzip_tpu.ops.banded_align import traceback_batch
    args = _args(case)
    res = impl(*args, W=case["W"], Lt=case["Lt"], G=case["G"], mode=MODE)
    if traceback:
        res["moves"] = traceback_batch(res["bp"], args[4], res["end_i"],
                                       res["end_j"],
                                       max_steps=len(case["lo"]) - 1)
    return jax.block_until_ready(res)


def memory_analysis(case) -> dict:
    """Compiled memory analysis of both DP programs at this shape."""
    from falcon_unzip_tpu.ops.banded_align import banded_align_batch
    from falcon_unzip_tpu.ops.cuda_align import _ffi_banded_dp, register
    register()
    qg, trg, n, m, lo = _args(case)
    st = {"W": case["W"], "Lt": case["Lt"], "G": case["G"], "mode": MODE}
    out = {}
    for name, lowered in (
            ("xla", banded_align_batch.lower(qg, trg, n, m, lo, **st)),
            ("cuda", _ffi_banded_dp.lower(qg, trg, n, m,
                                          Dmax=len(case["lo"]), **st))):
        ma = lowered.compile().memory_analysis()
        out[name] = {k: getattr(ma, k) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(ma, k)}
    return out


def check(case, n_oracle: int = 3) -> dict:
    """Kernel == scan bit for bit; a few pairs == the numpy oracle."""
    from falcon_unzip_tpu.ops.banded_align import (banded_align_batch,
                                                   moves_forward)
    from falcon_unzip_tpu.ops.cuda_align import cuda_banded_align
    from falcon_unzip_tpu.oracle import align as oa
    ref = {k: np.asarray(v) for k, v in run(banded_align_batch, case,
                                              True).items()}
    got = {k: np.asarray(v) for k, v in run(cuda_banded_align, case,
                                              True).items()}
    diff = {k: int((ref[k] != got[k]).sum()) for k in ref}
    if any(diff.values()):
        raise AssertionError(f"CUDA DP differs from the XLA scan: {diff}")
    moves = moves_forward(got["moves"])
    P = len(case["n"])
    for p in np.linspace(0, P - 1, n_oracle).astype(int):
        nq, mt = int(case["n"][p]), int(case["m"][p])
        qq, tt = case["q"][p, :nq], case["t"][p, :mt]
        dist, end, bp, lo = oa.banded_dp(qq, tt, case["W"], MODE)
        if (dist, end[1]) != (int(got["dist"][p]), int(got["end_j"][p])):
            raise AssertionError(f"pair {p}: oracle {(dist, end)} vs "
                                 f"{got['dist'][p], got['end_j'][p]}")
        if not np.array_equal(bp, got["bp"][:nq + mt + 1, p]):
            raise AssertionError(f"pair {p}: backpointers differ from the "
                                 "oracle")
        if not np.array_equal(oa.traceback_banded(bp, lo, end), moves[p]):
            raise AssertionError(f"pair {p}: moves differ from the oracle")
    return {"bitwise_equal_to_scan": True, "oracle_pairs": int(n_oracle),
            "tolerance": 0, "Dmax": len(case["lo"]),
            "cells": int(len(case["lo"]) * P * case["W"])}


def timings(case, reps: int) -> dict:
    """Seconds per call, alternating XLA, kernel, kernel, XLA."""
    from falcon_unzip_tpu.ops.banded_align import banded_align_batch
    from falcon_unzip_tpu.ops.cuda_align import cuda_banded_align
    impls = {"xla": banded_align_batch, "cuda": cuda_banded_align}
    out = {}
    for tb in (False, True):
        t = {k: [] for k in impls}
        for k in impls:                     # compile outside the window
            run(impls[k], case, tb)
        for _ in range(reps):
            for k in ("xla", "cuda", "cuda", "xla"):
                t0 = time.perf_counter()
                run(impls[k], case, tb)
                t[k].append(time.perf_counter() - t0)
        key = "dp_traceback" if tb else "dp"
        out[key] = {k: {"median_s": statistics.median(v), "runs_s": v}
                    for k, v in t.items()}
        out[key]["speedup"] = (out[key]["xla"]["median_s"]
                               / out[key]["cuda"]["median_s"])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args()
    from falcon_unzip_tpu.utils.device import nvidia_smi_name_power, require_gpu
    dev = require_gpu()
    card = nvidia_smi_name_power()
    print(card, flush=True)
    result = {"device": dev, "card": card, "shapes": {}}
    for si, (name, W, P, Lq, Lt, ql, tl) in enumerate(SHAPES):
        case = dp_case(W, P, Lq, Lt, ql, tl, seed=11 + si)
        r = {"W": W, "P": P, "Lq": Lq, "Lt": Lt, "mode": MODE}
        r.update(check(case))
        r["memory_analysis"] = memory_analysis(case)
        r.update(timings(case, a.reps))
        result["shapes"][name] = r
        print(name, json.dumps(r), flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
