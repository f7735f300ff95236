"""Split the 1-align stage wall into seed / DP dispatch / collect /
host post (anchor_trim + tag emission) at a given genome scale, on the
GPU (refuses to run without one; prints the card's name and power limit
and names the device in its output line).

  python scripts/profile_align.py [genome_bp] [coverage]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    genome_bp = int(sys.argv[1]) if len(sys.argv) > 1 else 300_000
    coverage = float(sys.argv[2]) if len(sys.argv) > 2 else 14.0
    from falcon_unzip_tpu.utils.compile_cache import enable
    from falcon_unzip_tpu.utils.device import (nvidia_smi_name_power,
                                               require_gpu)
    enable()
    device = require_gpu()
    card = nvidia_smi_name_power()
    print(card, flush=True)
    from falcon_unzip_tpu.models.aligner import (AlignerConfig,
                                                 ReadToContigAligner)
    from falcon_unzip_tpu.utils.simulate import make_diploid, simulate_reads

    from falcon_unzip_tpu.seq import SeqBatch
    n_ctg = max(1, genome_bp // 50_000)
    per = genome_bp // n_ctg
    contigs, seqs = [], []
    for ci in range(n_ctg):
        dip = make_diploid(length=per, het_rate=0.012, seed=100 + ci,
                           het_span=(0.2, 0.8))
        pr = simulate_reads(dip, coverage=coverage, read_len=2200,
                            error_rate=0.0, seed=200 + ci)
        seqs += [pr.batch.to_str(i) for i in range(len(pr.batch))]
        contigs.append(dip.hap0)
    reads = SeqBatch.from_strs(seqs)

    t0 = time.time()
    al = ReadToContigAligner(contigs, AlignerConfig())
    t_index = time.time() - t0

    import falcon_unzip_tpu.models.aligner as A
    from falcon_unzip_tpu.ops import banded_align as BA

    # NOTE: wrappers assume the patched functions never nest (true for
    # align_batch's straight-line stage structure); "other" is the
    # remainder — host prep fill loops, bucketing, result assembly
    times = {"seed": 0.0, "dispatch": 0.0, "collect": 0.0, "post": 0.0}

    orig_seed = A.seed_batch
    def seed_batch(*a, **k):
        t = time.time(); r = orig_seed(*a, **k); times["seed"] += time.time() - t
        return r
    A.seed_batch = seed_batch

    orig_dispatch = BA.BandedAligner.dispatch
    def dispatch(self, *a, **k):
        t = time.time(); r = orig_dispatch(self, *a, **k)
        times["dispatch"] += time.time() - t
        return r
    BA.BandedAligner.dispatch = dispatch

    orig_collect = BA.BandedAligner.collect
    def collect(self, *a, **k):
        t = time.time(); r = orig_collect(self, *a, **k)
        times["collect"] += time.time() - t
        return r
    BA.BandedAligner.collect = collect

    orig_trim = BA.anchor_trim
    def anchor_trim(*a, **k):
        t = time.time(); r = orig_trim(*a, **k); times["post"] += time.time() - t
        return r
    A.anchor_trim = anchor_trim

    t0 = time.time()
    aln = al.align_batch(reads)
    wall = time.time() - t0
    other = wall - sum(times.values())
    times["other"] = other if other >= 0 else float("nan")  # nan = nested
    print({"device": device, "card": card,
           "genome_bp": genome_bp, "n_reads": len(reads),
           "n_aligned": len(aln), "index_s": round(t_index, 2),
           "align_wall_s": round(wall, 2),
           **{k: round(v, 2) for k, v in times.items()}})


if __name__ == "__main__":
    main()
