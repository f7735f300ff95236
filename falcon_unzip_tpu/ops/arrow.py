"""Alpha/beta-spliced Arrow mutation rescoring on device.

Role parity: the cached-matrix mutation scoring inside ConsensusCore2
([U] variantCaller --algorithm=arrow, SURVEY.md §3.4 "HOTTEST loop of the
entire pipeline").  Real Arrow computes forward+backward ONCE per
(read, window-template) and scores each point mutation by splicing the
unchanged prefix/suffix columns across the mutated column — this module
is the batched device equivalent.

Re-design (vs the wavefront forward in ops.pairhmm):
* ROW sweep — one ``lax.scan`` step per read base i updates full
  (P, LJ) state rows.  M and I are elementwise from row i-1; the
  within-row D recurrence (D[j] from D[j-1]) is a log-semiring linear
  scan with CONSTANT decay tDD, computed by an unrolled Hillis-Steele
  doubling ladder of log2(LJ) shift+logaddexp levels (no gathers).
* The backward pass is the mirrored sweep (rows n..0) with the
  within-row recurrence on B_D running right-to-left.
* Per step the kernel emits ONLY the candidate-column values
  (take_along_axis at <=C forward and <=3C backward positions), so the
  full matrices never hit HBM: memory is O(R * P * C), not O(R * P * LJ).
* Splice assembly (oracle.hmm.splice_scores vectorized over P pairs,
  C candidate columns and 9 variants) runs in the same jitted program:
  ll[variant] = logsumexp_i of the boundary-crossing join — O(R) per
  variant instead of a full O(R * LJ) re-forward.
* Params are PER-PAIR (P, 10) so base-quality-conditioned emission
  tiers (SURVEY.md §2b variantCaller row) need no extra compile.

Numeric spec defined by oracle.hmm.forward_backward_full/splice_scores
(the doubling ladder reassociates logaddexp, so equality is to float32
tolerance, not bitwise).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..oracle.hmm import NEG, HMMParams
from ..seq import PAD


def _round_up(x: int, q: int = 128) -> int:
    return max(q, -(-x // q) * q)


def _shift_right(V, k, fill):
    """out[..., j] = V[..., j-k] (static k >= 1), left-filled."""
    pad = jnp.full(V.shape[:-1] + (k,), fill, V.dtype)
    return jnp.concatenate([pad, V[..., :-k]], axis=-1)


def _shift_left(V, k, fill):
    """out[..., j] = V[..., j+k] (static k >= 1), right-filled."""
    pad = jnp.full(V.shape[:-1] + (k,), fill, V.dtype)
    return jnp.concatenate([V[..., k:], pad], axis=-1)


def _scan_lse_right(u, c, LJ: int):
    """x[j] = logaddexp(u[j], x[j-1] + c)  (inclusive, x[-1] = -inf).

    Hillis-Steele doubling: level k folds in terms u[j - 2^k] + 2^k * c.
    c is per-pair (P, 1) and broadcasts.
    """
    neg = jnp.float32(NEG)
    k = 1
    while k < LJ:
        u = jnp.logaddexp(u, _shift_right(u, k, neg) + k * c)
        k *= 2
    return u


def _scan_lse_left(u, c, LJ: int):
    """x[j] = logaddexp(u[j], x[j+1] + c)  (inclusive, x[LJ] = -inf)."""
    neg = jnp.float32(NEG)
    k = 1
    while k < LJ:
        u = jnp.logaddexp(u, _shift_left(u, k, neg) + k * c)
        k *= 2
    return u


def _lse3(a, b, c):
    return jnp.logaddexp(jnp.logaddexp(a, b), c)


def arrow_splice_core(q, t, n, m, cand, pvec, qtier=None, tiers=None, *,
                      Lq: int, LJ: int, C: int):
    """Forward+backward+splice for P (read, template) pairs.

    q:    (P, Lq) int8 read codes, PAD-padded
    t:    (P, LJ) int8 template codes, PAD-padded (column j consumes
          t[:, j-1]; true template length m <= LJ - 1)
    n, m: (P,) int32 true lengths
    cand: (P, C) int32 candidate template positions (0-based, < m);
          -1 = unused slot
    pvec: (P, 10) float32 per-pair log-params, ops.pairhmm order
    qtier/tiers: optional PER-BASE quality conditioning (the real
          Arrow's IQV/DQV per-base tiers, SURVEY.md §2b variantCaller
          row).  qtier: (P, R) int32 tier id of read base i (rows >= n
          ignored); tiers: (T, 10) float32 per-tier log-params.  When
          given, every param of an HMM edge comes from the tier of the
          read base the edge consumes (D-only edges in row i take base
          i-1's tier, clipped at 0) and pvec is ignored.  Numeric spec:
          oracle.hmm.forward_backward_full_pb / splice_scores_pb.
          Shipping tier IDS (bytes/base) instead of (R, 10) param rows
          keeps the host->device transfer small.

    Returns (ll_cur (P,), ll_mut (P, C, 9) float32) with variant order
    [sub->0..3, ins 0..3 before p, del].  Unused slots score NEG.
    """
    P = q.shape[0]
    R = Lq + 1
    neg = jnp.float32(NEG)
    j_iota = jnp.arange(LJ, dtype=jnp.int32)[None, :]
    n = n.astype(jnp.int32)[:, None]
    m = m.astype(jnp.int32)[:, None]
    per_base = qtier is not None
    if per_base:
        tiers = tiers.astype(jnp.float32)             # (T, 10)
        qt = qtier.astype(jnp.int32)                  # (P, R)
        qt_m1 = jnp.concatenate([qt[:, :1], qt[:, :-1]], axis=1)

        def _row_params(src, i):
            """Row i's ten (P, 1) param scalars from tier ids `src`."""
            tsel = jax.lax.dynamic_slice(src, (0, i), (P, 1))
            pr = tiers[tsel[:, 0]]                    # (P, 10)
            return [pr[:, k : k + 1] for k in range(10)]

        frow = lambda i: _row_params(qt_m1, i)        # base i-1 (clip 0)
        brow = lambda i: _row_params(qt, i)           # base i
    else:
        _const = [pvec[:, k : k + 1] for k in range(10)]
        frow = brow = lambda i: _const

    jmask = j_iota <= m                       # (P, LJ) valid columns
    tg = _shift_right(t, 1, jnp.int8(PAD))    # tg[:, j] = t[j-1]
    qg = jnp.concatenate(                     # qg[:, i] = q[i-1]
        [jnp.full((P, 1), PAD, jnp.int8), q], axis=1)
    qpad = jnp.concatenate(                   # qpad[:, i] = q[i]
        [q, jnp.full((P, 1), PAD, jnp.int8)], axis=1)

    cand_ok = cand >= 0
    idxF = jnp.clip(cand, 0, LJ - 1)                          # (P, C)
    idxB = jnp.stack([jnp.clip(cand + s, 0, LJ - 1)
                      for s in range(3)], axis=1)             # (P, 3, C)
    idxB_flat = idxB.reshape(P, 3 * C)

    zrow = 0.0 * q[:, :1].astype(jnp.float32)   # (P,1) varying-typed zero
    NEGrow = jnp.full((P, LJ), NEG, jnp.float32) + zrow

    # ---- forward sweep: rows i = 0..Lq -------------------------------
    def fstep(carry, i):
        M1, I1, D1 = carry
        # every edge into row i consumes q[i-1]; row-i D edges are
        # conditioned on base i-1 too -> one tier row per step
        (em_match, em_mis, em_ins, tMM, tMI, tMD, tIM, tII, tDM,
         tDD) = frow(i)
        qc = jax.lax.dynamic_slice(qg, (0, i), (P, 1))        # q[i-1]
        em = jnp.where((qc == tg) & (qc < 4), em_match, em_mis)
        rowv = (i <= n[:, 0])[:, None]
        Md = _shift_right(M1, 1, neg)
        Id = _shift_right(I1, 1, neg)
        Dd = _shift_right(D1, 1, neg)
        M = em + _lse3(Md + tMM, Id + tIM, Dd + tDM)
        M = jnp.where((i >= 1) & (j_iota >= 1) & rowv & jmask, M, neg)
        M = jnp.where((i == 0) & (j_iota == 0), 0.0, M)
        I = em_ins + jnp.logaddexp(M1 + tMI, I1 + tII)
        I = jnp.where((i >= 1) & rowv & jmask, I, neg)
        u = _shift_right(M, 1, neg) + tMD
        u = jnp.where((j_iota >= 1) & rowv & jmask, u, neg)
        D = _scan_lse_right(u, tDD, LJ)
        D = jnp.where((j_iota >= 1) & rowv & jmask, D, neg)
        take = lambda A: jnp.take_along_axis(A, idxF, axis=1)
        return (M, I, D), (take(M), take(I), take(D))

    init = (NEGrow, NEGrow, NEGrow)
    _, (afM, afI, afD) = jax.lax.scan(
        fstep, init, jnp.arange(R, dtype=jnp.int32))
    # (R, P, C) -> (P, C, R)
    afM, afI, afD = (x.transpose(1, 2, 0) for x in (afM, afI, afD))

    # ---- backward sweep: rows i = Lq..0 ------------------------------
    def bstep(carry, i):
        BM1, BI1 = carry                         # rows i+1
        # M/I edges out of row i consume q[i]; within-row D edges
        # (tMD, tDD) stay conditioned on base i-1, mirroring forward
        (em_match, em_mis, em_ins, tMM, tMI, _tMD_i, tIM, tII, tDM,
         _tDD_i) = brow(i)
        (_em0, _em1, _em2, _t3, _t4, tMD, _t6, _t7, _t8, tDD) = frow(i)
        qc = jax.lax.dynamic_slice(qpad, (0, i), (P, 1))      # q[i]
        emB = jnp.where((qc == t) & (qc < 4), em_match, em_mis)
        go_m = emB + _shift_left(BM1, 1, neg)    # em(i+1,j+1)+BM[i+1,j+1]
        go_m = jnp.where((i <= n[:, 0] - 1)[:, None]
                         & (j_iota <= m - 1), go_m, neg)
        go_i = em_ins + BI1                      # em_ins + BI[i+1, j]
        go_i = jnp.where((i <= n[:, 0] - 1)[:, None] & jmask, go_i, neg)
        term = jnp.where((i == n[:, 0])[:, None] & (j_iota == m), 0.0, neg)
        w = jnp.logaddexp(tDM + go_m, term)
        BD = _scan_lse_left(w, tDD, LJ)
        BD = jnp.where(jmask, BD, neg)
        BM = jnp.logaddexp(
            _lse3(tMM + go_m, tMI + go_i, tMD + _shift_left(BD, 1, neg)),
            term)
        BM = jnp.where(jmask, BM, neg)
        BI = jnp.logaddexp(jnp.logaddexp(tIM + go_m, tII + go_i), term)
        BI = jnp.where(jmask, BI, neg)
        take = lambda A: jnp.take_along_axis(A, idxB_flat, axis=1)
        return (BM, BI), (take(BM), take(BD), BM[:, 0])

    initb = (NEGrow, NEGrow)
    _, (bM, bD, bm0) = jax.lax.scan(
        bstep, initb, jnp.arange(R - 1, -1, -1, dtype=jnp.int32))
    ll_cur = bm0[-1]                                          # BM[0, 0]
    # (R, P, 3C) emitted i=Lq..0 -> flip to i ascending -> (P, 3, C, R)
    bM = bM[::-1].transpose(1, 2, 0).reshape(P, 3, C, R)
    bD = bD[::-1].transpose(1, 2, 0).reshape(P, 3, C, R)

    # ---- splice assembly --------------------------------------------
    if per_base:
        # launch row i crosses by consuming q[i] (M step, tier qt[:, i])
        # or by a row-i D step (tier qt_m1[:, i])
        def p3(k):
            src = qt_m1 if k in (5, 9) else qt    # tMD/tDD: base i-1
            return tiers[:, k][src][:, None, :]   # (P, 1, R)
    else:
        def p3(k):
            return pvec[:, k, None, None]

    axM = _lse3(afM + p3(3), afI + p3(6), afD + p3(8))        # (P, C, R)
    axD = jnp.logaddexp(afM + p3(5), afD + p3(9))
    bM_next = jnp.concatenate(                 # BM[i+1, col]
        [bM[..., 1:], jnp.full(bM.shape[:-1] + (1,), NEG, jnp.float32)],
        axis=-1)

    em2_match = p3(0)
    em2_mis = p3(1)

    def cross(em, s):
        """Join launches through one base into backward column p+s."""
        contrib = jnp.logaddexp(axM + em + bM_next[:, s], axD + bD[:, s])
        return jax.nn.logsumexp(contrib, axis=-1)             # (P, C)

    qrow = qpad[:, None, :]                                   # (P, 1, R)
    lls = []
    for b in range(4):                                        # subs
        em = jnp.where(qrow == b, em2_match, em2_mis)
        lls.append(cross(em, 1))
    for b in range(4):                                        # ins
        em = jnp.where(qrow == b, em2_match, em2_mis)
        lls.append(cross(em, 0))
    # del: cross straight into base t[p+1] (landing col p+2) ...
    tp1 = jnp.take_along_axis(t, jnp.clip(cand + 1, 0, LJ - 1), axis=1)
    em_del = jnp.where((qrow == tp1[:, :, None])
                       & (tp1[:, :, None] < 4), em2_match, em2_mis)
    del_gen = cross(em_del, 2)
    # ... unless p == m-1: column p becomes terminal
    n3 = jnp.broadcast_to(n[:, :, None], (P, C, 1)).astype(jnp.int32)
    at_n = lambda A: jnp.take_along_axis(A, n3, axis=-1)[..., 0]
    del_last = _lse3(at_n(afM), at_n(afI), at_n(afD))
    lls.append(jnp.where(cand == m - 1, del_last, del_gen))

    ll_mut = jnp.stack(lls, axis=-1)                          # (P, C, 9)
    ll_mut = jnp.where(cand_ok[:, :, None], ll_mut, neg)
    return ll_cur, ll_mut


arrow_splice_batch = jax.jit(arrow_splice_core,
                             static_argnames=("Lq", "LJ", "C"))


class ArrowSplicer:
    """Batched splice scorer over ragged (read, template, candidates).

    One call scores P pairs x C candidate columns x 9 mutations plus the
    unmutated loglik, in a single compiled program per (Lq, LJ, C, chunk)
    shape bucket.  pvecs: optional (P, 10) per-pair log-params
    (ops.pairhmm.params_vector order); default = global HMMParams.
    """

    def __init__(self, max_cand: int = 8, params: HMMParams | None = None,
                 chunk: int = 512, fixed_lq: int | None = None,
                 fixed_lj: int | None = None,
                 tier_params: np.ndarray | None = None):
        """fixed_lq/fixed_lj: pin the padded read/template shapes.  With
        data-derived shapes, a pair's logsumexp reduction tree depends on
        the LONGEST member of its batch, so the same pair scored in a
        differently-composed batch can differ in the last float bit;
        pinned shapes make every score a pure function of the pair alone
        — required for contig-owner sharding to stay byte-identical with
        the single-host run (callers must filter inputs to fit)."""
        from .pairhmm import params_vector
        self.C = max_cand
        self.chunk = chunk
        self.pvec1 = params_vector(params)
        self.fixed_lq = fixed_lq
        self.fixed_lj = fixed_lj
        # (T, 10) per-tier log-params for PER-BASE quality conditioning
        # (qtiers argument of __call__); None = per-pair pvec mode
        self.tier_params = (np.asarray(tier_params, np.float32)
                            if tier_params is not None else None)

    def _shapes(self, qs, ts):
        max_q = max((len(q) for q in qs), default=1)
        max_t = max((len(t) for t in ts), default=1)
        if self.fixed_lq is not None:
            assert max_q <= self.fixed_lq and max_t < self.fixed_lj, (
                max_q, max_t, self.fixed_lq, self.fixed_lj)
            return self.fixed_lq, self.fixed_lj
        return _round_up(max_q), _round_up(max_t + 1)

    def _pick_chunk(self, N: int) -> int:
        # power-of-two ladder: small batches don't pad to the full
        # chunk, big batches reuse one compiled program per dispatch
        chunk = 8
        while chunk < min(N, self.chunk):
            chunk *= 2
        return min(chunk, self.chunk)

    def _dispatch(self, qa, ta, nn, mm, ca, pv, Lq: int, LJ: int,
                  qt=None):
        return arrow_splice_batch(
            jnp.asarray(qa), jnp.asarray(ta), jnp.asarray(nn),
            jnp.asarray(mm), jnp.asarray(ca), jnp.asarray(pv),
            None if qt is None else jnp.asarray(qt),
            None if qt is None else jnp.asarray(self.tier_params),
            Lq=Lq, LJ=LJ, C=self.C)

    def __call__(self, qs, ts, cands, pvecs=None, qtiers=None):
        """qs/ts: lists of int8 arrays; cands: (N, C) int32 (-1 pad) or
        list of lists; pvecs: optional (N, 10); qtiers: optional list of
        per-pair int8/int32 tier-id arrays (len == len(qs[i])) selecting
        rows of the constructor's tier_params table per READ BASE.
        Returns (ll_cur (N,), ll_mut (N, C, 9))."""
        N = len(qs)
        C = self.C
        cand = np.full((N, C), -1, np.int32)
        if isinstance(cands, np.ndarray):
            cand[:, :cands.shape[1]] = cands[:, :C]
        else:
            for i, cc in enumerate(cands):
                cc = list(cc)[:C]
                cand[i, :len(cc)] = cc
        Lq, LJ = self._shapes(qs, ts)
        chunk = self._pick_chunk(N)
        # two-phase async (see models.aligner): dispatch EVERY chunk's
        # program first, then fetch all results in two concatenated
        # copies instead of one blocking device round trip per chunk
        use_tiers = qtiers is not None and self.tier_params is not None
        pend = []
        for lo in range(0, N, chunk):
            hi = min(N, lo + chunk)
            P = chunk                        # fixed: one compile per bucket
            qa = np.full((P, Lq), PAD, np.int8)
            ta = np.full((P, LJ), PAD, np.int8)
            nn = np.zeros(P, np.int32)
            mm = np.zeros(P, np.int32)
            ca = np.full((P, C), -1, np.int32)
            pv = np.tile(self.pvec1, (P, 1)).astype(np.float32)
            qt = np.zeros((P, Lq + 1), np.int8) if use_tiers else None
            for i in range(lo, hi):
                q, t = qs[i], ts[i]
                qa[i - lo, :len(q)] = q
                ta[i - lo, :len(t)] = t
                nn[i - lo] = len(q)
                mm[i - lo] = len(t)
                if use_tiers:
                    qt[i - lo, :len(qtiers[i])] = qtiers[i]
            ca[:hi - lo] = cand[lo:hi]
            if pvecs is not None:
                pv[:hi - lo] = pvecs[lo:hi]
            pend.append(self._dispatch(qa, ta, nn, mm, ca, pv, Lq, LJ,
                                       qt=qt))
        if len(pend) == 1:
            cur_all = np.asarray(pend[0][0])
            mut_all = np.asarray(pend[0][1])
        else:
            cur_all = np.asarray(jnp.concatenate([c for c, _ in pend]))
            mut_all = np.asarray(jnp.concatenate([m for _, m in pend]))
        return cur_all[:N].copy(), mut_all[:N].copy()
