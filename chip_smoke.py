"""Smoke test of the whole system on one NVIDIA GPU.

  python chip_smoke.py [--genome-bp N]        # phases 1-4, one card
  python chip_smoke.py --four-cards [--genome-bp N]

Phases, in order, all in this one process (a JAX process reserves most of
the card's memory, so no second one may hold it):

1. device   — JAX's first device must be a GPU; prints the card's name
              and power limit (nvidia-smi).
2. kernels  — at real widths, each against its plain reference:
              the CUDA banded edit DP vs the XLA scan (bit for bit) and the
              numpy oracle (tolerance 0), at the read-alignment and the
              haplotig-placement shapes, with each program's
              memory_analysis(); the Arrow splice at the polisher's
              len_cap vs oracle/hmm.py; the phase-vote matmuls on a 25x
              500 kb contig vs numpy, exactly.
3. pipeline — a simulated diploid (n50 profile: 6 contigs, 25x preads,
              raw reads at 29x, het rate 0.012), `cli unzip` then
              `cli quiver`; checks 6 primaries, non-empty haplotigs and
              truth QV >= 45 for p and h; prints the stage walls.
4. gpu tests — the tests marked `gpu`, run in this process.

--four-cards runs only the pipeline, on a 4-device mesh and then on one
device, and compares the outputs.  The last line of standard output is
one JSON object, {"ok": true, "device": {...}}; any failure exits
non-zero without it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULT_GENOME_BP = 1_000_000
COVERAGE = 25.0
PROFILE = "n50"
N_PRIMARIES = 6
MIN_TRUTH_QV = 45.0
OUTPUTS = ("3-unzip/all_p_ctg.fa", "3-unzip/all_h_ctg.fa",
           "4-polish/cns_p_ctg.fasta", "4-polish/cns_h_ctg.fasta")


def log(*a) -> None:
    print(*a, flush=True)


def phase_device() -> dict:
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (first device is "
                         f"on platform {dev.platform!r})")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    from falcon_unzip_tpu.utils.compile_cache import enable
    from falcon_unzip_tpu.utils.device import describe, nvidia_smi_name_power
    log(nvidia_smi_name_power())
    log("compile cache:", enable())
    return describe()


def check_banded_dp() -> None:
    import dp_kernel_bench as dkb
    for si, (name, W, P, Lq, Lt, ql, tl) in enumerate(dkb.SHAPES):
        t0 = time.perf_counter()
        case = dkb.dp_case(W, P, Lq, Lt, ql, tl, seed=11 + si)
        r = dkb.check(case)
        log(f"banded DP {name}: W={W} P={P} Lq={Lq} Lt={Lt} "
            f"mode={dkb.MODE} Dmax={r['Dmax']}: CUDA kernel == XLA scan "
            f"bit for bit (dist, end_i, end_j, bp); {r['oracle_pairs']} "
            f"pairs == oracle.align.banded_dp; integer, tolerance 0 "
            f"({time.perf_counter() - t0:.1f} s)")
        log(f"  memory_analysis: {json.dumps(dkb.memory_analysis(case))}")


def check_arrow() -> None:
    import numpy as np

    from falcon_unzip_tpu.models.polisher import PolisherConfig
    from falcon_unzip_tpu.ops.arrow import ArrowSplicer
    from falcon_unzip_tpu.oracle import hmm as oh
    from falcon_unzip_tpu.utils.simulate import mutate_read, random_genome
    cfg = PolisherConfig()
    cap, C, N = cfg.len_cap(), cfg.arrow_candidates, cfg.splice_chunk
    rng = np.random.default_rng(5)
    qs, ts, cands = [], [], []
    for k in range(N):
        t = random_genome(cfg.window, 700 + k)
        qs.append(mutate_read(t[12:-12], 0.03, rng)[:cap - 1])
        ts.append(t)
        cands.append(sorted(rng.choice(cfg.window, C, replace=False)))
    t0 = time.perf_counter()
    sp = ArrowSplicer(max_cand=C, params=cfg.params, chunk=N,
                      fixed_lq=cap, fixed_lj=cap)
    ll_cur, ll_mut = sp(qs, ts, cands)
    dt = time.perf_counter() - t0
    if ll_cur.shape != (N,) or ll_mut.shape != (N, C, 9):
        raise AssertionError(f"arrow shapes {ll_cur.shape} {ll_mut.shape}")
    if not (np.isfinite(ll_cur).all() and np.isfinite(ll_mut).all()):
        raise AssertionError("arrow: non-finite log-likelihoods")
    for k in (0, N - 1):
        want = oh.forward_full(qs[k], ts[k], cfg.params)
        np.testing.assert_allclose(ll_cur[k], want, rtol=2e-3, atol=2e-3)
        fb = oh.forward_backward_full(qs[k], ts[k], cfg.params)
        for ci, p in enumerate(cands[k]):
            np.testing.assert_allclose(
                ll_mut[k, ci], oh.splice_scores(qs[k], ts[k], fb, p,
                                                cfg.params),
                rtol=2e-3, atol=2e-3, err_msg=f"pair {k} cand {p}")
    log(f"arrow_splice_core: {N} pairs x {C} candidates x 9 at len_cap "
        f"{cap}, float32; 2 pairs == oracle/hmm.py within rtol = atol = "
        f"2e-3 (the doubling ladder reassociates logaddexp; GPU exp/log "
        f"differ from the CPU's) ({dt:.1f} s incl. compile)")


def _votes_case(rng, contig_bp=500_000, coverage=25.0, read_len=2200,
                het_rate=0.012, block_sites=100):
    """A read x het-site matrix in {-1, 0, 1} as a 25x contig gives it."""
    import numpy as np
    S = int(contig_bp * het_rate)
    R = int(contig_bp * coverage / read_len)
    pos = np.sort(rng.choice(contig_bp, S, replace=False))
    M = np.zeros((R, S), np.int8)
    starts = rng.integers(0, contig_bp - read_len, R)
    lo = np.searchsorted(pos, starts)
    hi = np.searchsorted(pos, starts + read_len)
    for r in range(R):
        k = hi[r] - lo[r]
        M[r, lo[r]:hi[r]] = rng.choice(np.array([-1, 1], np.int8), k) * \
            (rng.random(k) > 0.05)
    B = -(-S // block_sites)
    onehot = np.zeros((S, B), np.int8)
    onehot[np.arange(S), np.arange(S) // block_sites] = 1
    sgn = rng.choice(np.array([-1, 1], np.int32), S)
    return M, onehot, sgn


def check_votes() -> None:
    import numpy as np

    from falcon_unzip_tpu.ops.association import (read_block_votes,
                                                  read_block_votes_batch)
    rng = np.random.default_rng(9)
    cases = [_votes_case(rng) for _ in range(2)]

    def ref(M, onehot, sgn):
        Mi = M.astype(np.int64)
        return ((Mi * sgn[None, :]) @ onehot.astype(np.int64),
                np.abs(Mi) @ onehot.astype(np.int64))

    for M, onehot, sgn in cases:
        v, c = (np.asarray(x) for x in read_block_votes(M, onehot, sgn))
        rv, rc = ref(M, onehot, sgn)
        if not (np.array_equal(v, rv) and np.array_equal(c, rc)):
            raise AssertionError("read_block_votes differs from numpy")
    vb, cb = (np.asarray(x) for x in read_block_votes_batch(
        *(np.stack(x) for x in zip(*cases))))
    for g, case in enumerate(cases):
        rv, rc = ref(*case)
        if not (np.array_equal(vb[g], rv) and np.array_equal(cb[g], rc)):
            raise AssertionError("read_block_votes_batch differs from numpy")
    R, S = cases[0][0].shape
    log(f"read_block_votes(_batch): 25x 500 kb contig, {R} reads x {S} "
        f"sites x {cases[0][1].shape[1]} blocks, float32 matmul at XLA's "
        f"default precision == numpy int64 exactly (tolerance 0)")


def run_pipeline(genome_bp: int, workdir: str, n_devices: int = 0) -> dict:
    """Simulate, then `cli unzip` and `cli quiver`; returns the checks."""
    from e2e_bench import _stage_metrics, _truth_qv, simulate

    from falcon_unzip_tpu.cli import main as cli_main
    from falcon_unzip_tpu.io.fasta import read_fasta
    t0 = time.perf_counter()
    haps, lens = simulate(workdir, genome_bp, COVERAGE, PROFILE)
    sim_s = time.perf_counter() - t0
    out = os.path.join(workdir, "out")
    run_json = os.path.join(workdir, "run.json")
    with open(run_json, "w") as fh:
        json.dump({"preads": f"{workdir}/preads.fa",
                   "reads": f"{workdir}/raw.fa",
                   "draft": f"{workdir}/draft.fa", "out_dir": out,
                   "mesh": {"n_devices": n_devices}}, fh)
    walls = {}
    for cmd in ("unzip", "quiver"):
        t0 = time.perf_counter()
        if cli_main([cmd, run_json]) != 0:
            raise AssertionError(f"cli {cmd} failed")
        walls[cmd] = time.perf_counter() - t0
    n_p = len(read_fasta(f"{out}/3-unzip/all_p_ctg.fa"))
    n_h = len(read_fasta(f"{out}/3-unzip/all_h_ctg.fa"))
    qv_p, _ = _truth_qv(f"{out}/4-polish/cns_p_ctg.fasta", haps)
    qv_h, _ = _truth_qv(f"{out}/4-polish/cns_h_ctg.fasta", haps)
    return {"out": out, "sim_s": sim_s, "walls": walls, "n_p": n_p,
            "n_h": n_h, "qv_p": qv_p, "qv_h": qv_h, "lens": lens,
            "stages": {k: v.get("s") for k, v in
                       _stage_metrics(out).items() if "s" in v}}


def check_pipeline(r: dict) -> None:
    log(f"  primaries {r['n_p']} (want {N_PRIMARIES}), haplotigs "
        f"{r['n_h']}, truth QV p {r['qv_p']} h {r['qv_h']} "
        f"(want >= {MIN_TRUTH_QV})")
    log(f"  stage walls (s): {json.dumps(r['stages'])}")
    log(f"  simulate {r['sim_s']:.1f} s, unzip {r['walls']['unzip']:.1f} s,"
        f" quiver {r['walls']['quiver']:.1f} s, total "
        f"{sum(r['walls'].values()):.1f} s")
    if r["n_p"] != N_PRIMARIES:
        raise AssertionError(f"{r['n_p']} primaries, want {N_PRIMARIES}")
    if r["n_h"] == 0:
        raise AssertionError("all_h_ctg.fa is empty")
    if min(r["qv_p"] or 0, r["qv_h"] or 0) < MIN_TRUTH_QV:
        raise AssertionError(f"truth QV p {r['qv_p']} h {r['qv_h']} "
                             f"below {MIN_TRUTH_QV}")


def pipeline_params(genome_bp: int) -> str:
    return (f"pipeline: {genome_bp} bp diploid, {PROFILE} profile "
            f"({N_PRIMARIES} contigs), preads {COVERAGE:g}x 2.2 kb, raw "
            f"reads {COVERAGE + 4:g}x 1.8 kb at 3% error, het rate 0.012; "
            f"cut from the ~40 Mb fungal deployment (BASELINE config 5) "
            f"to this size so the smoke finishes in its time")


def phase_gpu_tests() -> None:
    import pytest

    class Count:
        def __init__(self):
            self.outcomes = []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.outcomes.append((report.nodeid, report.outcome))

    # conftest.py keeps the CPU unless JAX_PLATFORMS names a platform;
    # this process already holds the GPU, so the tests run on it here
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    c = Count()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")],
                     plugins=[c])
    bad = [o for o in c.outcomes if o[1] != "passed"]
    if rc != 0 or bad or not c.outcomes:
        raise AssertionError(f"gpu tests: rc {rc}, not passed: {bad}")
    log(f"gpu tests: {len(c.outcomes)} passed")


def four_cards(genome_bp: int) -> None:
    import jax
    if len(jax.devices()) < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, JAX sees "
                         f"{len(jax.devices())}")
    log(pipeline_params(genome_bp))
    log("mesh ('data', 'window') over jax.devices(); alignment and "
        "overlap still run on device 0 (parallel.distributed splits "
        "them by process only)")
    runs = {}
    with tempfile.TemporaryDirectory() as td:
        for nd in (4, 1):
            wd = os.path.join(td, f"mesh{nd}")
            os.makedirs(wd)
            log(f"pipeline on mesh.n_devices={nd}:")
            runs[nd] = run_pipeline(genome_bp, wd, n_devices=nd)
            check_pipeline(runs[nd])
        same = {}
        for rel in OUTPUTS:
            with open(os.path.join(runs[4]["out"], rel), "rb") as a, \
                    open(os.path.join(runs[1]["out"], rel), "rb") as b:
                same[rel] = a.read() == b.read()
    log(f"4-device vs 1-device outputs byte-identical: {json.dumps(same)}")
    if (runs[4]["n_p"], runs[4]["n_h"]) != (runs[1]["n_p"], runs[1]["n_h"]):
        raise AssertionError("contig counts differ between 4 and 1 devices")
    for k in ("qv_p", "qv_h"):
        if abs(runs[4][k] - runs[1][k]) > 0.5:
            raise AssertionError(f"{k} differs by more than 0.5 between 4 "
                                 f"and 1 devices")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-bp", type=int, default=DEFAULT_GENOME_BP)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the pipeline on 4 devices vs 1")
    a = ap.parse_args()
    t_all = time.perf_counter()
    device = phase_device()
    if a.four_cards:
        four_cards(a.genome_bp)
    else:
        for name, fn in (("banded DP", check_banded_dp),
                         ("arrow", check_arrow), ("votes", check_votes)):
            t0 = time.perf_counter()
            fn()
            log(f"[phase kernels/{name}] {time.perf_counter() - t0:.1f} s")
        log(pipeline_params(a.genome_bp))
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as td:
            check_pipeline(run_pipeline(a.genome_bp, td))
        log(f"[phase pipeline] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_gpu_tests()
        log(f"[phase gpu tests] {time.perf_counter() - t0:.1f} s")
    log(f"[total] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
