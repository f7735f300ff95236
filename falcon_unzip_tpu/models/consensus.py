"""falcon_sense-style batched consensus model (BASELINE config 1 gate).

Role parity: [U] falcon-kit falcon.c::generate_consensus via
fc_consensus.py — template + supporting reads -> consensus sequence by
banded alignment + per-column tag voting (SURVEY.md §3.5).

Re-design: supporting reads are placed on the template by the k-mer
chainer, aligned as ONE bucketed device batch with the banded wavefront
kernel, and the vote/emit step consumes the flat tag arrays.  Long
templates are windowed (window + halo) so the DP shapes stay fixed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..seq import PAD, SeqBatch
from ..ops.consensus import consensus_from_votes, vote_matrix
from ..ops.banded_align import (BandedAligner, anchor_trim,
                                moves_to_tags_vec)
from ..ops.kmer_index import KmerIndex, seed_batch


@dataclasses.dataclass
class ConsensusConfig:
    k: int = 13
    band: int = 128
    min_cov: int = 2
    min_idt: float = 0.7
    batch_pairs: int = 64
    window_pad: int = 48
    anchor_k: int = 8            # exact-match run anchoring both aln ends


class FalconSense:
    """Batched template+reads consensus caller."""

    def __init__(self, cfg: ConsensusConfig | None = None):
        self.cfg = cfg or ConsensusConfig()
        self._aligner = BandedAligner(W=self.cfg.band, mode="tglocal")

    def __call__(self, template: np.ndarray,
                 reads: list[np.ndarray]) -> np.ndarray:
        cfg = self.cfg
        template = np.asarray(template, dtype=np.int8)
        index = KmerIndex.build([template], k=cfg.k)

        from .aligner import clip_query_overhang
        seqs = [np.asarray(r, dtype=np.int8) for r in reads]
        strand, _ctg, score, d_min, d_max = seed_batch(index, seqs)
        jobs = []
        for ri in np.nonzero(score >= 0)[0]:
            r = seqs[ri]
            if strand[ri] == 1:
                from ..seq import revcomp
                r = revcomp(r)
            d0, d1 = int(d_min[ri]), int(d_max[ri])
            r, q_lo = clip_query_overhang(r, d0, d1, len(template),
                                          cfg.window_pad)
            if len(r) < cfg.k:
                continue
            lo = max(0, d0 + q_lo - cfg.window_pad)
            hi = min(len(template),
                     d1 + q_lo + len(r) + cfg.k + cfg.window_pad)
            if hi - lo >= cfg.k:
                jobs.append((lo, hi, r))

        tags_list = []
        buckets: dict[tuple[int, int], list[int]] = {}
        for ji, (lo, hi, r) in enumerate(jobs):
            # target bucket tracks the query bucket: one compiled shape
            # per query bucket (models.aligner notes)
            from .aligner import _bucket, _t_bucket
            bq = _bucket(len(r))
            buckets.setdefault((bq, _t_bucket(hi - lo, bq)),
                               []).append(ji)
        # two-phase async: dispatch all chunks, then collect (see
        # models.aligner — avoids one blocking device round trip per chunk)
        pending = []  # (chunk, handle)
        chunk_pairs = cfg.batch_pairs
        for (bq, bt), jidx in sorted(buckets.items()):
            for s in range(0, len(jidx), chunk_pairs):
                chunk = jidx[s : s + chunk_pairs]
                P = len(chunk)
                qa = np.full((P, bq), PAD, np.int8)
                ta = np.full((P, bt), PAD, np.int8)
                nn = np.zeros(P, np.int32)
                mm = np.zeros(P, np.int32)
                for pi, ji in enumerate(chunk):
                    lo, hi, r = jobs[ji]
                    qa[pi, : len(r)] = r
                    ta[pi, : hi - lo] = template[lo:hi]
                    nn[pi] = len(r)
                    mm[pi] = hi - lo
                pending.append((chunk,
                                self._aligner.dispatch(qa, ta, nn, mm,
                                                       want_moves=True)))
        for chunk, handle in pending:
                res = self._aligner.collect(handle)
                for pi, ji in enumerate(chunk):
                    lo, hi, r = jobs[ji]
                    # anchor both alignment ends (see models.aligner)
                    cl = anchor_trim(r, template[lo:hi], res["moves"][pi],
                                     int(res["end_j"][pi]),
                                     k=cfg.anchor_k)
                    if cl is None:
                        continue
                    span = max(cl["end_j"] - cl["start_j"], 1)
                    if 1.0 - cl["dist"] / span < cfg.min_idt:
                        continue
                    tags_list.append(moves_to_tags_vec(
                        cl["q"], cl["moves"],
                        t_offset=lo + cl["start_j"]))

        votes = vote_matrix(tags_list, len(template))
        cns, _ = consensus_from_votes(votes, template, min_cov=cfg.min_cov)
        return cns
