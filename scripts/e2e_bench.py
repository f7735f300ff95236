"""End-to-end unzip+polish wall-clock bench (north-star metric 2).

Simulates a diploid genome at the given scale, runs the full 3-unzip +
4-polish pipeline on the GPU, and prints the card's name and power limit,
then one JSON line with stage wall-clocks, bases/s and truth QV.
Refuses to run without a GPU.

  python scripts/e2e_bench.py [genome_bp] [coverage] [uniform|n50|fungal]
                              [--workdir DIR] [--keep] [--dp-scan]
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _truth_qv(cns_path: str, haps: list, chunk: int = 500):
    """Mean phred QV of polished contigs vs the SIMULATED TRUTH
    (north-star metric 3), mosaic-aware: FALCON primaries are
    pseudo-haplotypes that legitimately SWITCH haplotype between phase
    blocks, so the contig is scored in `chunk`-bp pieces, each against
    its best-matching haplotype (exact-substring fast path, banded
    re-alignment fallback).  Base errors raise the chunk's edit
    distance; phase switches cost at most the few het sites inside the
    single chunk containing the junction."""
    import numpy as np

    from falcon_unzip_tpu.io.fasta import read_fasta
    from falcon_unzip_tpu.models.aligner import (AlignerConfig,
                                                 ReadToContigAligner)
    from falcon_unzip_tpu.seq import SeqBatch, decode

    batch = read_fasta(cns_path)
    if not len(batch):
        return None, None
    hap_strs = [decode(h) for h in haps]
    qvs: list[float] = []
    al = None
    # error attribution (VERDICT r2 weak #5): how much of the residual
    # edit distance sits in haplotype-SWITCH chunks (legitimate mosaic
    # junctions of a FALCON pseudo-haplotype primary) vs interior base
    # errors vs unalignable sequence
    bd = {"n_chunks": 0, "n_exact": 0, "n_switch": 0, "n_interior": 0,
          "n_unaligned": 0, "err_switch": 0.0, "err_interior": 0.0,
          "err_unaligned": 0.0}

    def _chunk_kind(p: str) -> str:
        probe = min(150, max(50, len(p) // 3))
        head = {h for h, hs in enumerate(hap_strs) if p[:probe] in hs}
        tail = {h for h, hs in enumerate(hap_strs) if p[-probe:] in hs}
        if head and tail and not (head & tail):
            return "switch"
        return "interior"

    rc_tr = str.maketrans("ACGT", "TGCA")

    for i in range(len(batch)):
        s = batch.to_str(i)
        # orientation: graph walks legitimately emit reverse-complement
        # contigs; score whichever orientation matches the truth (probe
        # three interior chunks, majority wins)
        s_r = s.translate(rc_tr)[::-1]
        probes = [s[o : o + chunk] for o in
                  (0, max(0, len(s) // 2), max(0, len(s) - chunk))]
        n_f = sum(any(p in h for h in hap_strs) for p in probes if p)
        probes_r = [s_r[o : o + chunk] for o in
                    (0, max(0, len(s) // 2), max(0, len(s) - chunk))]
        n_r = sum(any(p in h for h in hap_strs) for p in probes_r if p)
        if n_r > n_f:
            s = s_r
        if any(s in h for h in hap_strs):
            qvs.append(60.0)
            bd["n_chunks"] += max(1, len(s) // chunk)
            bd["n_exact"] += max(1, len(s) // chunk)
            continue
        pieces = [s[o : o + chunk] for o in range(0, len(s), chunk)]
        pieces = [p for p in pieces if len(p) >= 50]
        resid_idx = [k for k, p in enumerate(pieces)
                     if not any(p in h for h in hap_strs)]
        bd["n_chunks"] += len(pieces)
        bd["n_exact"] += len(pieces) - len(resid_idx)
        err = 0.0
        if resid_idx:
            if al is None:
                al = ReadToContigAligner(haps, AlignerConfig(band=256))
            sub = SeqBatch.from_strs([pieces[k] for k in resid_idx])
            res = al.align_batch(sub)
            best = {r: float("inf") for r in range(len(sub))}
            for a in range(len(res)):
                best[int(res.read_id[a])] = min(
                    best[int(res.read_id[a])], float(res.dist[a]))
            for r in range(len(sub)):
                if np.isfinite(best[r]):
                    err += best[r]
                    kind = _chunk_kind(pieces[resid_idx[r]])
                    bd[f"n_{kind}"] += 1
                    bd[f"err_{kind}"] += best[r]
                else:
                    # unalignable chunk counts fully wrong
                    err += len(sub.row(r))
                    bd["n_unaligned"] += 1
                    bd["err_unaligned"] += len(sub.row(r))
        rate = err / max(len(s), 1)
        qvs.append(float(min(60.0, -10.0 * np.log10(max(rate, 1e-6)))))
    return round(float(np.mean(qvs)), 1), bd


def contig_lengths(genome_bp: int, profile: str) -> list[int]:
    """Per-contig lengths for a simulation profile.

    uniform : historical shape — equal ~50 kb contigs (fast, but a toy
              for a tool whose reference assembled multi-Mb contigs).
    n50     : realistic FALCON-primary shape (VERDICT r3 next #2) — a
              few contigs spanning ~half the genome down to ~5%, e.g.
              10 Mb -> [5 Mb, 2 Mb, 1 Mb, 650 kb, 650 kb, 700 kb].
    fungal  : BASELINE.json config-5 shape — a ~40 Mb-class diploid
              fungal draft as FALCON emits it: 16 contigs from 15% of
              the genome down to ~2%, N50 ≈ 7.5% of genome (3 Mb at
              40 Mb, matching published fungal FALCON assemblies).
    """
    if profile == "n50":
        fr = [0.5, 0.2, 0.1, 0.065, 0.065, 0.07]
        lens = [int(genome_bp * f) for f in fr[:-1]]
        return lens + [genome_bp - sum(lens)]
    if profile == "fungal":
        fr = [0.15, 0.125, 0.1, 0.0875, 0.075, 0.075, 0.0625, 0.0625,
              0.05, 0.05, 0.0375, 0.0375, 0.025, 0.025, 0.02]
        lens = [int(genome_bp * f) for f in fr]
        return lens + [genome_bp - sum(lens)]
    n_ctg = max(1, genome_bp // 50_000)
    return [genome_bp // n_ctg] * n_ctg


def _stage_metrics(out_dir: str) -> dict:
    """Last metrics row per stage key from the run's metrics.jsonl."""
    path = os.path.join(out_dir, "metrics.jsonl")
    rows: dict = {}
    try:
        with open(path) as fh:
            for line in fh:
                r = json.loads(line)
                k = r.pop("stage", None)
                r.pop("ts", None)
                if not k or k == "phasing":  # phasing is per-contig
                    continue
                while k in rows:             # unzip + quiver both log
                    k += "+"                 # align_compute etc.
                rows[k] = r
    except OSError:
        pass
    return rows


def simulate(d: str, genome_bp: int, coverage: float, profile: str):
    """Write preads.fa, raw.fa and draft.fa for a simulated diploid into
    d (preads at `coverage`, 2.2 kb, error-free; raw reads at coverage
    + 4, 1.8 kb, 3% error; het rate 0.012).  Returns (true haplotypes,
    contig lengths)."""
    from falcon_unzip_tpu.io.fasta import write_fasta
    from falcon_unzip_tpu.seq import decode
    from falcon_unzip_tpu.utils.simulate import make_diploid, simulate_reads

    lens = contig_lengths(genome_bp, profile)
    pread_names, pread_seqs, raw_names, raw_seqs, drafts = [], [], [], [], []
    true_haps = []
    for ci, per in enumerate(lens):
        dip = make_diploid(length=per, het_rate=0.012, seed=100 + ci,
                           het_span=(0.2, 0.8))
        true_haps += [dip.hap0, dip.hap1]
        pr = simulate_reads(dip, coverage=coverage, read_len=2200,
                            error_rate=0.0, seed=200 + ci)
        rw = simulate_reads(dip, coverage=coverage + 4, read_len=1800,
                            error_rate=0.03, seed=300 + ci)
        pread_names += [f"c{ci}/{n}" for n in pr.batch.names]
        pread_seqs += [pr.batch.to_str(i) for i in range(len(pr.batch))]
        raw_names += [f"c{ci}/{n}" for n in rw.batch.names]
        raw_seqs += [rw.batch.to_str(i) for i in range(len(rw.batch))]
        drafts.append((f"draft{ci}", decode(dip.hap0)))
    write_fasta(f"{d}/preads.fa", zip(pread_names, pread_seqs))
    write_fasta(f"{d}/raw.fa", zip(raw_names, raw_seqs))
    write_fasta(f"{d}/draft.fa", drafts)
    return true_haps, lens


def use_dp_scan() -> None:
    """Run the banded DP as the XLA scan on every platform (for timing
    the scan against the CUDA kernel on the GPU)."""
    from falcon_unzip_tpu.ops import banded_align
    banded_align.dp_for_platform = lambda platform: \
        banded_align.banded_align_batch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("genome_bp", type=int, nargs="?", default=150_000)
    ap.add_argument("coverage", type=float, nargs="?", default=14.0)
    ap.add_argument("profile", nargs="?", default="uniform",
                    choices=("uniform", "n50", "fungal"))
    ap.add_argument("--workdir", default="",
                    help="scratch directory (default: under TMPDIR)")
    ap.add_argument("--keep", action="store_true",
                    help="reuse the workdir's inputs and finished stages")
    ap.add_argument("--dp-scan", action="store_true",
                    help="time the XLA scan in place of the CUDA DP kernel")
    a = ap.parse_args()
    genome_bp, coverage, profile = a.genome_bp, a.coverage, a.profile

    from falcon_unzip_tpu.config import PipelineConfig
    from falcon_unzip_tpu.pipeline.quiver import run_quiver
    from falcon_unzip_tpu.pipeline.unzip import run_unzip
    from falcon_unzip_tpu.utils import simulate as sim_mod
    from falcon_unzip_tpu.utils.compile_cache import enable
    from falcon_unzip_tpu.utils.device import (nvidia_smi_name_power,
                                               require_gpu)
    enable()
    device = require_gpu()
    card = nvidia_smi_name_power()
    print(card, flush=True)
    if a.dp_scan:
        use_dp_scan()

    d = a.workdir or os.path.join(tempfile.gettempdir(),
                                  f"e2e_bench_{genome_bp}_{profile}")
    # sim identity: params + simulator source hash; a kept dir whose
    # fingerprint mismatches is discarded instead of silently scoring
    # truth QV against the wrong haplotypes
    import hashlib
    sim_src = hashlib.sha256(
        open(sim_mod.__file__, "rb").read()).hexdigest()[:16]
    fp = {"genome_bp": genome_bp, "coverage": coverage,
          "profile": profile, "sim_src": sim_src, "v": 2}
    fp_path = f"{d}/sim_params.json"
    # --keep: reuse an existing scratch dir — the sim is re-derived
    # (seeded, for truth QV) but input files are not rewritten, so the
    # drivers' Stage markers resume completed stages (mtime-fingerprint
    # semantics).  Interrupted big runs continue instead of restarting.
    keep = a.keep and os.path.isdir(d)
    if keep:
        try:
            keep = json.load(open(fp_path)) == fp
        except (OSError, ValueError):
            keep = False
    if not keep:
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        json.dump(fp, open(fp_path, "w"))

    t0 = time.perf_counter()
    if keep and os.path.exists(f"{d}/preads.fa"):
        with tempfile.TemporaryDirectory() as td:  # truth only
            true_haps, lens = simulate(td, genome_bp, coverage, profile)
    else:
        true_haps, lens = simulate(d, genome_bp, coverage, profile)
    sim_s = time.perf_counter() - t0
    n_ctg = len(lens)

    cfg = PipelineConfig(preads=f"{d}/preads.fa", reads=f"{d}/raw.fa",
                         draft=f"{d}/draft.fa", out_dir=f"{d}/out")
    t0 = time.perf_counter()
    u = run_unzip(cfg)
    unzip_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q = run_quiver(cfg)
    polish_s = time.perf_counter() - t0

    total = unzip_s + polish_s
    qv_p, bd_p = _truth_qv(f"{d}/out/4-polish/cns_p_ctg.fasta", true_haps)
    qv_h, bd_h = _truth_qv(f"{d}/out/4-polish/cns_h_ctg.fasta", true_haps)
    print(json.dumps({
        "metric": "e2e_unzip_polish_wall_s",
        "genome_bp": genome_bp,
        "n_contigs": n_ctg,
        "profile": profile,
        "contig_lens": lens if n_ctg <= 16 else None,
        "coverage": coverage,
        "dp": "xla_scan" if a.dp_scan else "cuda_kernel",
        "stage_metrics": _stage_metrics(f"{d}/out"),
        "device": device,
        "card": card,
        "sim_s": sim_s,
        "unzip_s": unzip_s,
        "polish_s": polish_s,
        "total_s": total,
        "genome_bases_per_sec": genome_bp / total,
        "p_ctg": u["p_ctg"], "h_ctg": u["h_ctg"],
        "mean_qv": q.get("mean_qv"),
        "truth_qv_p": qv_p, "truth_qv_h": qv_h,
        "qv_breakdown_p": bd_p, "qv_breakdown_h": bd_h,
    }))


if __name__ == "__main__":
    main()
