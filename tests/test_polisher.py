"""Polisher: draft with injected errors + noisy reads -> exact truth."""
import numpy as np
import pytest

from falcon_unzip_tpu.models.aligner import AlignerConfig, ReadToContigAligner
from falcon_unzip_tpu.models.polisher import Polisher, PolisherConfig
from falcon_unzip_tpu.utils.simulate import (make_diploid, mutate_read,
                                             random_genome, simulate_reads)


def _inject_errors(seq, n_err, seed):
    rng = np.random.default_rng(seed)
    out = seq.copy()
    pos = rng.choice(len(seq) - 20, size=n_err, replace=False) + 10
    for p in pos:
        out[p] = (out[p] + 1 + rng.integers(0, 3)) % 4
    return out, np.sort(pos)


@pytest.fixture(scope="module")
def polish_setup():
    truth = random_genome(4000, 31)
    draft, err_pos = _inject_errors(truth, 12, 32)
    rng = np.random.default_rng(33)
    from falcon_unzip_tpu.seq import SeqBatch
    reads = [mutate_read(truth, 0.04, rng) for _ in range(40)]
    # give each read a random placement so windows have staggered coverage
    segs, names = [], []
    for i, r in enumerate(reads):
        s = rng.integers(0, 1500)
        e = min(len(r), s + 2500)
        segs.append(r[s:e])
        names.append(f"r{i}")
    batch = SeqBatch.from_strs(segs, names=names)
    al = ReadToContigAligner([draft])
    aln = al.align_batch(batch)
    return truth, draft, err_pos, aln


def test_vote_polish_fixes_draft(polish_setup):
    truth, draft, err_pos, aln = polish_setup
    pol = Polisher(PolisherConfig(arrow_rounds=0))
    out = pol.polish_contig("ctg0", draft, aln, 0)
    assert np.array_equal(out.seq, truth), (
        len(out.seq), len(truth),
        int((out.seq[:len(truth)] != truth[:len(out.seq)]).sum()))


def test_arrow_polish_also_exact(polish_setup):
    truth, draft, err_pos, aln = polish_setup
    pol = Polisher(PolisherConfig(arrow_rounds=1))
    out = pol.polish_contig("ctg0", draft, aln, 0)
    assert np.array_equal(out.seq, truth)


def test_qv_emitted(polish_setup):
    truth, draft, err_pos, aln = polish_setup
    pol = Polisher(PolisherConfig(arrow_rounds=0))
    out = pol.polish_contig("ctg0", draft, aln, 0)
    assert len(out.qv) == len(out.seq)
    assert out.qv.mean() > 10


def _window_setup(n_sub=2, n_indel=1, seed=60, cov=14, L=384):
    """A single window whose draft carries clustered sub+indel errors that
    one vote pass cannot fully fix (low-coverage ambiguity injected by
    splitting reads between two alleles at one column)."""
    rng = np.random.default_rng(seed)
    truth = random_genome(L, seed)
    draft = truth.copy()
    pos = np.sort(rng.choice(np.arange(40, L - 40), size=n_sub + n_indel,
                             replace=False))
    for p in pos[:n_sub]:
        draft[p] = (draft[p] + 1) % 4
    dels = pos[n_sub:]
    draft = np.delete(draft, dels)          # deletion errors in the draft
    reads = [mutate_read(truth, 0.05, rng) for _ in range(cov)]
    return truth, draft, reads


def test_arrow_converges_on_multi_error_window():
    """2 subs + 1 deletion in one window: one round is not enough; the
    convergence loop recovers the exact truth (VERDICT.md missing #3)."""
    from falcon_unzip_tpu.seq import SeqBatch
    truth, draft, reads = _window_setup()
    batch = SeqBatch.from_strs(reads, names=[f"r{i}" for i in range(len(reads))])
    al = ReadToContigAligner([draft])
    aln = al.align_batch(batch)
    # force mutation testing to do the work: min_cov high enough that the
    # vote consensus keeps draft bases at every column (margin_frac=1.01
    # marks every covered column low-margin, so candidates always exist)
    cfg = PolisherConfig(window=512, arrow_rounds=8, arrow_candidates=8,
                         margin_frac=0.9)
    out = Polisher(cfg).polish_contig("w", draft, aln, 0)
    assert np.array_equal(out.seq, truth), (
        len(out.seq), len(truth),
        int((out.seq[: len(truth)] != truth[: len(out.seq)]).sum()
            if len(out.seq) == len(truth) else -1))


def test_arrow_queue_exceeds_chunk_still_converges():
    """7 seeded errors with arrow_candidates=2: the round-robin candidate
    queue cycles through chunks of 2 and still recovers the exact truth
    (VERDICT.md weak #4: frozen prep-time candidate list)."""
    from falcon_unzip_tpu.seq import SeqBatch
    rng = np.random.default_rng(71)
    L = 384
    truth = random_genome(L, 71)
    draft = truth.copy()
    pos = np.sort(rng.choice(np.arange(30, L - 30, 12), size=6,
                             replace=False))
    for p in pos[:5]:
        draft[p] = (draft[p] + 1 + rng.integers(0, 3)) % 4
    draft = np.delete(draft, pos[5])          # plus one deletion error
    reads = [mutate_read(truth, 0.04, rng) for _ in range(16)]
    batch = SeqBatch.from_strs(reads, names=[f"r{i}"
                                             for i in range(len(reads))])
    aln = ReadToContigAligner([draft]).align_batch(batch)
    cfg = PolisherConfig(window=512, arrow_rounds=24, arrow_candidates=2,
                         margin_frac=0.9)
    out = Polisher(cfg).polish_contig("w", draft, aln, 0)
    assert np.array_equal(out.seq, truth), (
        len(out.seq), len(truth),
        int((out.seq[: len(truth)] != truth[: len(out.seq)]).sum()
            if len(out.seq) == len(truth) else -1))


def test_arrow_matches_window_oracle():
    """Production greedy loop == oracle.polish_window_oracle decisions on
    a small window (same candidates, same full-HMM scorer)."""
    from falcon_unzip_tpu.models import polisher as MP
    from falcon_unzip_tpu.oracle.hmm import (HMMParams, forward_full,
                                             polish_window_oracle)
    rng = np.random.default_rng(7)
    truth = random_genome(48, 7)
    draft = truth.copy()
    draft[10] = (draft[10] + 1) % 4
    draft[30] = (draft[30] + 2) % 4
    reads = [mutate_read(truth, 0.03, rng) for _ in range(8)]

    class FullScorer:
        def __call__(self, q, t, n, m):
            return np.array([forward_full(q[i, : n[i]], t[i, : m[i]])
                             for i in range(len(n))], np.float32)

    cand = [10, 30]
    ref = polish_window_oracle(draft, reads, cand, max_rounds=8)

    st = MP._WinState(cns=draft.copy(), votes=np.zeros((48, 9, 5), np.int32),
                      segs=reads, active=True, cand=list(cand))
    pol = Polisher(PolisherConfig(arrow_rounds=8),
                   scorer=FullScorer())
    pol._refine_windows([st])
    assert np.array_equal(st.cns, ref)
    assert np.array_equal(st.cns, truth)


def test_margin_qv_overrides():
    """Mutation-tested columns get likelihood-margin QVs."""
    from falcon_unzip_tpu.seq import SeqBatch
    truth, draft, reads = _window_setup(n_sub=1, n_indel=0, seed=61)
    batch = SeqBatch.from_strs(reads, names=[f"r{i}" for i in range(len(reads))])
    aln = ReadToContigAligner([draft]).align_batch(batch)
    # margin_frac > 1 marks every covered column low-margin, forcing
    # mutation tests (and hence margin QVs) even on a clean consensus
    cfg = PolisherConfig(window=512, arrow_rounds=4, margin_frac=1.01)
    pol = Polisher(cfg)
    states = pol._prep_windows(draft, aln, 0)
    pol._refine_windows(states)
    tested = [st for st in states if st.qv_pos]
    assert tested, "no window recorded margin QVs"
    for st in tested:
        assert all(2 <= v <= 60 for v in st.qv_val)


def test_het_skip_gate_keeps_template_allele():
    """A balanced biallelic column (residual het mixture) must NOT be
    mutation-tested: the template's block-consistent allele survives.
    An unbalanced error column at the same coverage still gets fixed."""
    from falcon_unzip_tpu.seq import SeqBatch

    truth = random_genome(3000, 91)
    draft = truth.copy()
    err_p = 700
    draft[err_p] = (draft[err_p] + 1) % 4          # a real error
    het_p = 1500
    alt = truth.copy()
    alt[het_p] = (alt[het_p] + 2) % 4              # the other haplotype
    rng = np.random.default_rng(92)
    reads = []
    for i in range(30):
        src = truth if i % 2 == 0 else alt         # 50/50 het mixture
        reads.append(mutate_read(src, 0.02, rng))
    batch = SeqBatch.from_strs(reads, names=[f"r{i}" for i in range(30)])
    aln = ReadToContigAligner([draft]).align_batch(batch)

    pol = Polisher(PolisherConfig(window=512, arrow_rounds=8,
                                  het_skip_frac=0.35))
    out = pol.polish_contig("c", draft, aln, 0)
    assert out.seq[err_p] == truth[err_p], "real error must be fixed"
    # at the het site the template's allele (truth[het_p], since draft
    # carries it) must survive the 50/50 vote split
    assert out.seq[het_p] == draft[het_p], \
        "balanced het column must keep the template allele"


def test_phase_route_mask_drops_opposite_reads():
    """Reads phased OPPOSITE to the template's own alleles are dropped;
    same-phase and unphased reads are kept (quiver rr_hctg_track role)."""
    from falcon_unzip_tpu.pipeline.quiver import _phase_route_mask
    from falcon_unzip_tpu.config import PipelineConfig
    from falcon_unzip_tpu.seq import SeqBatch

    dip = make_diploid(length=9000, het_rate=0.02, seed=95,
                       het_span=(0.1, 0.9))
    rng = np.random.default_rng(96)
    reads, srcs = [], []
    for i in range(60):
        src = i % 2
        g = dip.hap0 if src == 0 else dip.hap1
        s = rng.integers(0, 5000)
        reads.append(mutate_read(g[s : s + 4000], 0.02, rng))
        srcs.append(src)
    batch = SeqBatch.from_strs(reads,
                               names=[f"r{i}" for i in range(60)])
    aln = ReadToContigAligner([dip.hap0]).align_batch(batch)
    cfg = PipelineConfig(preads="x", out_dir="/tmp/x")
    keep = _phase_route_mask(aln, [0], [len(dip.hap0)], [dip.hap0], cfg)
    # template IS hap0: every dropped record must be a hap1 read, and a
    # decent share of hap1 reads must actually be dropped
    dropped_srcs = {srcs[int(aln.read_id[a])]
                    for a in np.nonzero(~keep)[0]}
    assert dropped_srcs <= {1}
    n_h1 = sum(1 for a in range(len(aln))
               if srcs[int(aln.read_id[a])] == 1)
    assert (~keep).sum() >= 0.5 * n_h1


def test_het_gate_deletion_won_column_restores_not_corrupts():
    """ADVICE r3 (high): when the GAP vote wins a balanced het column,
    the gate must restore the template allele at the junction — NOT
    overwrite the next emitted base (cns_of_t points at the following
    cell when nothing was emitted at delta 0)."""
    template = np.array([0, 1, 2, 3, 0], np.int8)
    votes = np.zeros((5, 2, 5), np.int32)
    for t in range(5):
        votes[t, 0, template[t]] = 20
    # pos 2: deletion wins (11 gap vs 9 template base) — balanced het-del
    votes[2, 0, :] = 0
    votes[2, 0, 4] = 11
    votes[2, 0, 2] = 9
    pol = Polisher(PolisherConfig(arrow_rounds=0, min_cov=3,
                                  het_skip_frac=0.35))
    cns, _cov, cns_of_t = pol._vote_consensus(votes, template)
    assert np.array_equal(cns, template), cns.tolist()
    # the restored column maps to its own base; later columns shifted
    assert cns_of_t[2] == 2 and cns_of_t[3] == 3 and cns_of_t[4] == 4
    # without the gate the deletion goes through untouched
    pol0 = Polisher(PolisherConfig(arrow_rounds=0, min_cov=3,
                                   het_skip_frac=0.0))
    cns0, _c, _m = pol0._vote_consensus(votes, template)
    assert np.array_equal(cns0, np.array([0, 1, 3, 0], np.int8))


def test_het_gate_min_count_floor_keeps_real_errors_testable():
    """ADVICE r3 (low): a 3/2 split at minimum coverage is noise, not a
    het site — the column must stay in the mutation-test queue."""
    template = np.array([0, 1, 2, 3, 0], np.int8)
    votes = np.zeros((5, 2, 5), np.int32)
    for t in range(5):
        votes[t, 0, template[t]] = 20
    votes[2, 0, :] = 0
    votes[2, 0, 1] = 3       # low-margin 3/2 split, cov 5
    votes[2, 0, 2] = 2
    pol = Polisher(PolisherConfig(arrow_rounds=1, min_cov=3,
                                  het_skip_frac=0.35, het_min_count=3))
    cns, _cov, cns_of_t = pol._vote_consensus(votes, template)
    cand = pol._candidates(cns, votes, cns_of_t)
    assert int(cns_of_t[2]) in cand, (cand, cns_of_t.tolist())
