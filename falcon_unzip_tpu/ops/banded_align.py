"""Batched banded edit-distance alignment on device.

Re-design of [U] falcon-kit DW_banded.c::align (the O(nd) banded
diff aligner) and of blasr's banded extension DP (SURVEY.md §2b):

* The band has FIXED width W and follows the slope-1/2 diagonal with a
  data-independent shift schedule (``oracle.align.band_lo``), so one
  ``lax.scan`` step updates a whole (P, W) tile of P pairs with pure
  elementwise min/compare ops — no gathers, no per-pair control flow.
* Query/target characters for an antidiagonal are CONTIGUOUS slices of a
  guard-padded query and a guard-padded *reversed* target, shared across
  the batch — two ``dynamic_slice`` ops per step.
* Backpointers stream out as an int8 (Dmax, P, W) tensor; traceback is a
  second batched scan of (P,) gathers.

On a GPU the same recurrence runs as one CUDA kernel (``ops.cuda_align``),
bit-equal to ``banded_align_batch``; ``BandedAligner`` picks by platform.

Semantics are defined by and tested against ``oracle.align``.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..seq import PAD
from ..oracle.align import GAP, INF, band_lo

MOVE_DIAG, MOVE_UP, MOVE_LEFT, MOVE_NONE = 0, 1, 2, 3


def _round128(x: int) -> int:
    return -(-x // 128) * 128


def build_schedule(Lq: int, Lt: int, W: int):
    """Host-side band schedule for padded lengths (Lq, Lt): lo per antidiag."""
    Dmax = Lq + Lt + 1
    lo = np.array([band_lo(d, W) for d in range(Dmax)], dtype=np.int32)
    return Dmax, lo


def prepare_batch(q: np.ndarray, t: np.ndarray, W: int):
    """Guard-pad query and reversed target for shared-slice wavefront access.

    q: (P, Lq) int8 padded with PAD;  t: (P, Lt) int8.
    Returns (qg, trg, G) with
      qg[:, k]  == q[:, k-1]      (so q[i-1] = qg[i])
      trg[:, G+k] == t[:, Lt-1-k] (so t[j-1] = trg[G + Lt - j])
    """
    P, Lq = q.shape
    _, Lt = t.shape
    LQG = _round128(max((Lq + Lt + 1) // 2 + W // 2 + 2, Lq + 2))
    qg = np.full((P, LQG), PAD, dtype=np.int8)
    qg[:, 1 : Lq + 1] = q
    G = W + max(0, (Lq - Lt + 1) // 2) + 2
    LTG = _round128(G + Lt + W + 2)
    trg = np.full((P, LTG), PAD, dtype=np.int8)
    trg[:, G : G + Lt] = t[:, ::-1]
    return qg, trg, G


def _shift(V, k, fill):
    """out[w] = V[w+k] (k in {-1, 0, 1}), edges filled."""
    if k == 0:
        return V
    col = jnp.full((V.shape[0], 1), fill, dtype=V.dtype)
    if k == 1:
        return jnp.concatenate([V[:, 1:], col], axis=1)
    return jnp.concatenate([col, V[:, :-1]], axis=1)


def _shift_sel(V, s, base_k, fill):
    """Select shift by traced scalar s in {0,1}: shift amount base_k + s."""
    a = _shift(V, base_k, fill)
    b = _shift(V, base_k + 1, fill)
    return jnp.where(s == 0, a, b)


@functools.partial(jax.jit, static_argnames=("W", "Lt", "G", "mode", "want_bp"))
def banded_align_batch(qg, trg, n, m, lo_arr, *, W: int, Lt: int, G: int,
                       mode: str = "global", want_bp: bool = True):
    """Batched banded DP.

    qg:  (P, LQG) int8 guarded query
    trg: (P, LTG) int8 guarded reversed target
    n, m: (P,) int32 true lengths
    lo_arr: (Dmax,) int32 band schedule

    Returns dict with dist (P,), end_i/end_j (P,), and bp (Dmax, P, W) int8
    (only if want_bp).
    """
    P = qg.shape[0]
    Dmax = lo_arr.shape[0]
    w_iota = jnp.arange(W, dtype=jnp.int32)[None, :]          # (1, W)
    inf = jnp.int32(INF)
    n = n.astype(jnp.int32)[:, None]
    m = m.astype(jnp.int32)[:, None]

    def step(carry, d):
        V1, V2, best, best_j, final = carry
        lo = lo_arr[d]
        lo1 = jnp.where(d >= 1, lo_arr[jnp.maximum(d - 1, 0)], 0)
        lo2 = jnp.where(d >= 2, lo_arr[jnp.maximum(d - 2, 0)], 0)
        s1 = lo - lo1
        s2 = lo - lo2

        i = lo + w_iota                                        # (1, W)
        j = d - i

        up = _shift_sel(V1, s1, -1, inf)        # (i-1, j)   at w + s1 - 1
        left = _shift_sel(V1, s1, 0, inf)       # (i, j-1)   at w + s1
        diag = _shift_sel(V2, s2, -1, inf)      # (i-1, j-1) at w + s2 - 1

        qi = jax.lax.dynamic_slice(qg, (0, lo), (P, W))
        tj = jax.lax.dynamic_slice(trg, (0, G + Lt - d + lo), (P, W))
        sub = jnp.where((qi == tj) & (qi < 4), 0, 1).astype(jnp.int32)

        cd = jnp.where((i >= 1) & (j >= 1), diag + sub, inf)
        cu = jnp.where(i >= 1, up + 1, inf)
        cl = jnp.where(j >= 1, left + 1, inf)

        V = jnp.minimum(jnp.minimum(cd, cu), cl)
        mv = jnp.where(cd <= V, MOVE_DIAG,
                       jnp.where(cu <= V, MOVE_UP, MOVE_LEFT)).astype(jnp.int8)

        if mode == "tglocal":
            origin = (i == 0) & (j >= 0)
        else:
            origin = (i == 0) & (j == 0)
        valid = (i >= 0) & (i <= n) & (j >= 0) & (j <= m)
        V = jnp.where(origin, 0, V)
        V = jnp.where(valid, V, inf)
        V = jnp.minimum(V, inf)
        bp_d = jnp.where(valid & ~origin & (V < inf), mv,
                         MOVE_NONE).astype(jnp.int8)

        # qglocal: running best over cells with i == n
        at_end = valid & (i == n)
        Vend = jnp.where(at_end, V, inf)
        wmin = jnp.argmin(Vend, axis=1)
        vmin = jnp.take_along_axis(Vend, wmin[:, None], axis=1)[:, 0]
        upd = vmin < best
        best = jnp.where(upd, vmin, best)
        best_j = jnp.where(upd, d - (lo + wmin.astype(jnp.int32)), best_j)

        # global: capture V[n, m] when d == n + m
        hit = (d == (n + m)[:, 0])
        wnm = jnp.clip(n[:, 0] - lo, 0, W - 1)
        vnm = jnp.take_along_axis(V, wnm[:, None], axis=1)[:, 0]
        final = jnp.where(hit, vnm, final)

        out = bp_d if want_bp else jnp.zeros((), dtype=jnp.int8)
        return (V, V1, best, best_j, final), out

    V0 = jnp.full((P, W), INF, dtype=jnp.int32)
    init = (V0, V0, jnp.full((P,), INF, dtype=jnp.int32),
            jnp.full((P,), -1, dtype=jnp.int32),
            jnp.full((P,), INF, dtype=jnp.int32))
    (_, _, best, best_j, final), bp = jax.lax.scan(
        step, init, jnp.arange(Dmax, dtype=jnp.int32))

    if mode == "global":
        dist, end_i, end_j = final, n[:, 0], m[:, 0]
    else:  # qglocal / tglocal: best cell on row i == n
        dist, end_i, end_j = best, n[:, 0], best_j
    out = {"dist": dist, "end_i": end_i, "end_j": end_j}
    if want_bp:
        out["bp"] = bp
    return out


@functools.partial(jax.jit, static_argnames=("max_steps",))
def traceback_batch(bp, lo_arr, end_i, end_j, *, max_steps: int):
    """Batched traceback. Returns moves (P, max_steps) int8 in REVERSE order
    (first entry = last move); MOVE_NONE past the end."""
    Dmax, P, W = bp.shape
    bp_flat = bp.transpose(1, 0, 2).reshape(P, Dmax * W)

    def step(carry, _):
        i, j = carry
        d = i + j
        lo = lo_arr[jnp.clip(d, 0, Dmax - 1)]
        w = jnp.clip(i - lo, 0, W - 1)
        done = (i <= 0) & (j <= 0)
        idx = jnp.clip(d, 0, Dmax - 1) * W + w
        mv = jnp.take_along_axis(bp_flat, idx[:, None], axis=1)[:, 0]
        mv = jnp.where(done, MOVE_NONE, mv).astype(jnp.int8)
        di = jnp.where((mv == MOVE_DIAG) | (mv == MOVE_UP), 1, 0)
        dj = jnp.where((mv == MOVE_DIAG) | (mv == MOVE_LEFT), 1, 0)
        return (i - di, j - dj), mv

    (_, _), moves = jax.lax.scan(
        step, (end_i.astype(jnp.int32), end_j.astype(jnp.int32)),
        None, length=max_steps)
    return moves.T  # (P, max_steps)


def moves_forward(moves_rev: np.ndarray) -> list[np.ndarray]:
    """Reverse-order padded moves -> list of forward move arrays per pair."""
    out = []
    for row in np.asarray(moves_rev):
        row = row[row != MOVE_NONE]
        out.append(row[::-1].astype(np.int8))
    return out


@jax.jit
def pack_moves2(moves: jnp.ndarray) -> jnp.ndarray:
    """(P, S) int8 moves (values 0..3) -> (P, ceil(S/16)) int32, 2 bits
    per move.  Shrinks the device->host transfer 4x."""
    P, S = moves.shape
    S16 = -(-S // 16) * 16
    m = jnp.pad(moves.astype(jnp.int32) & 3, ((0, 0), (0, S16 - S)),
                constant_values=MOVE_NONE)
    m = m.reshape(P, S16 // 16, 16)
    shifts = (2 * jnp.arange(16, dtype=jnp.int32))[None, None, :]
    return jnp.sum(m << shifts, axis=-1).astype(jnp.int32)


@jax.jit
def _combine_results(packed, dist, end_i, end_j):
    """Fuse per-chunk results into one (P, K+3) int32 device array so the
    host pays one device-to-host copy per chunk instead of four."""
    tail = jnp.stack([dist.astype(jnp.int32), end_i.astype(jnp.int32),
                      end_j.astype(jnp.int32)], axis=1)
    return jnp.concatenate([packed, tail], axis=1)


@jax.jit
def _summarize_moves(moves_rev, dist, end_i, end_j):
    """Per-pair alignment summary ON DEVICE — (P, 7) int32.

    The overlapper only needs the matched interval and the up-run trims,
    not the move string: reducing on device shrinks the per-chunk fetch
    from ~1 MB of packed moves to 28 B/pair.

    moves_rev is REVERSE move order with a MOVE_NONE-padded suffix, so:
    forward-leading up run = the run of MOVE_UP ending the valid prefix;
    forward-trailing up run = the run of MOVE_UP starting at index 0.
    Columns: dist, end_j, n_t (diag+left moves), lead, trail, n_up, end_i.
    """
    valid = moves_rev != MOVE_NONE
    is_up = moves_rev == MOVE_UP
    is_t = (moves_rev == MOVE_DIAG) | (moves_rev == MOVE_LEFT)
    n_t = jnp.sum(is_t & valid, axis=1)
    n_up = jnp.sum(is_up & valid, axis=1)
    # run of UP closing the valid prefix: suffix-AND of (UP or padding)
    up_or_pad = is_up | ~valid
    suff = jnp.flip(jnp.cumprod(
        jnp.flip(up_or_pad, axis=1).astype(jnp.int32), axis=1), axis=1)
    lead = jnp.sum(suff.astype(bool) & valid, axis=1)
    trail = jnp.sum(jnp.cumprod(is_up.astype(jnp.int32), axis=1), axis=1)
    return jnp.stack([dist.astype(jnp.int32), end_j.astype(jnp.int32),
                      n_t.astype(jnp.int32), lead.astype(jnp.int32),
                      trail.astype(jnp.int32), n_up.astype(jnp.int32),
                      end_i.astype(jnp.int32)], axis=1)


def unpack_moves2(packed: np.ndarray, S: int) -> np.ndarray:
    """Inverse of pack_moves2 on host: (P, S16/16) int32 -> (P, S) int8."""
    p = np.asarray(packed)
    shifts = (2 * np.arange(16, dtype=np.int32))[None, None, :]
    m = (p[:, :, None] >> shifts) & 3
    return m.reshape(p.shape[0], -1)[:, :S].astype(np.int8)


def moves_to_tags_vec(q: np.ndarray, moves: np.ndarray,
                      t_offset: int = 0) -> np.ndarray:
    """Vectorized numpy tags from forward moves (spec: oracle.moves_to_tags)."""
    if len(moves) == 0:
        return np.zeros((0, 3), dtype=np.int32)
    mv = np.asarray(moves)
    is_d = mv == MOVE_DIAG
    is_u = mv == MOVE_UP
    is_l = mv == MOVE_LEFT
    consumes_t = is_d | is_l
    consumes_q = is_d | is_u
    j = np.cumsum(consumes_t) - 1          # t index of this move (for d/l)
    i = np.cumsum(consumes_q) - 1          # q index (for d/u)
    # t_pos: for diag/left -> j; for up -> last consumed t index (ffill)
    last_j = np.where(consumes_t, j, -1)
    last_j = np.maximum.accumulate(last_j)
    t_pos = np.where(consumes_t, j, last_j)
    # delta for an up at position p = p - (index of last t-consuming move
    # before p); count of consecutive ups since last diag/left.
    pos_in = np.arange(len(mv))
    lastc = np.where(consumes_t, pos_in, -1)
    lastc = np.maximum.accumulate(lastc)
    delta = np.where(is_u, pos_in - lastc, 0).astype(np.int64)
    base = np.where(is_l, GAP, q[np.clip(i, 0, max(len(q) - 1, 0))])
    tags = np.stack([t_pos + t_offset, delta, base], axis=1).astype(np.int32)
    return tags


def anchor_trim(q: np.ndarray, t_win: np.ndarray, moves: np.ndarray,
                end_j: int, k: int = 8):
    """Trim an alignment to start AND end on a run of k exact diagonal
    matches (vectorized numpy).

    An edit-distance DP with free target ends has no match bonus, so
    query bases hanging past the target (or erroneous read ends) smear
    into mismatch/insertion mixtures at the alignment's extremes — and
    those become insertion VOTES that corrupt consensus near contig
    ends.  DALIGNER/blasr end their alignments at exact anchor points
    ([U] SURVEY.md §2b); this does the same post-hoc: everything before
    the first and after the last k-long exact-match run is clipped, and
    the clipped query bases emit no tags.

    Returns None when no k-run exists (reject the alignment), else a
    dict with the kept ``moves``, sliced ``q``, contig-window
    ``start_j``/``end_j`` of the kept span, and its edit ``dist``.
    """
    mv = np.asarray(moves)
    L = len(mv)
    if L < k:
        return None
    consumes_t = (mv == MOVE_DIAG) | (mv == MOVE_LEFT)
    consumes_q = (mv == MOVE_DIAG) | (mv == MOVE_UP)
    start_j = int(end_j) - int(consumes_t.sum())
    j = start_j + np.cumsum(consumes_t) - 1
    i = np.cumsum(consumes_q) - 1
    qi = np.clip(i, 0, max(len(q) - 1, 0))
    tj = np.clip(j, 0, max(len(t_win) - 1, 0))
    diag_eq = ((mv == MOVE_DIAG) & (q[qi] == t_win[tj]) & (q[qi] < 4)
               & (j >= 0) & (j < len(t_win)))
    # local-alignment end trim (Kadane on the move path, match +1 /
    # edit -2): an edit-distance DP has no match bonus, so a chimeric
    # junction or long garbage tail rides the min-cost path at ~50%
    # matches and an accidental k-run can anchor it — the max-score
    # subpath drops any tail that is net noise while a 3%-error read
    # (expected +0.91/move) keeps its full span.  First-optimal ties.
    sc = np.where(diag_eq, 1, -2).astype(np.int64)
    pre = np.concatenate([[0], np.cumsum(sc)])          # (L+1,)
    run_min = np.minimum.accumulate(pre[:-1])           # min prefix < j
    gain = pre[1:] - run_min
    hi_k = int(np.argmax(gain))                         # subpath end
    if gain[hi_k] <= 0:
        return None
    lo_k = int(np.nonzero(pre[: hi_k + 1] == run_min[hi_k])[0][0])
    win_ok = np.zeros(L, bool)
    win_ok[lo_k : hi_k + 1] = True
    c = np.concatenate([[0], np.cumsum(diag_eq.astype(np.int32))])
    ok = (c[k:] - c[:-k]) == k          # ok[s]: moves[s : s+k] all match
    ok &= win_ok[:L - k + 1] & win_ok[k - 1:]   # runs inside the subpath
    idx = np.nonzero(ok)[0]
    if len(idx) == 0:
        return None
    s0, s_last = int(idx[0]), int(idx[-1])
    kept = mv[s0 : s_last + k]
    q0 = int(consumes_q[:s0].sum())
    q1 = int(consumes_q[s_last + k:].sum())
    t0 = int(consumes_t[:s0].sum())
    t1 = int(consumes_t[s_last + k:].sum())
    return {
        "moves": kept,
        "q": q[q0 : len(q) - q1],
        "q0": q0,
        "start_j": start_j + t0,
        "end_j": int(end_j) - t1,
        "dist": int((~diag_eq[s0 : s_last + k]).sum()),
    }


def dp_for_platform(platform: str):
    """The banded DP for a JAX platform: the CUDA kernel on ``gpu``, the
    XLA scan elsewhere (the CPU is the test platform)."""
    if platform == "gpu":
        from .cuda_align import cuda_banded_align
        return cuda_banded_align
    return banded_align_batch


def inflight_limit(chunk_bytes: int, bytes_limit: int) -> int:
    """Dispatched-but-uncollected chunks allowed at once: a quarter of the
    device's memory over one chunk's device bytes, at least 1."""
    return max(1, (bytes_limit // 4) // max(1, chunk_bytes))


def device_bytes_limit(device=None) -> int:
    """Memory the device may allocate: the allocator's ``bytes_limit``
    where it reports one (GPU), else the host's physical memory (CPU)."""
    device = device or jax.devices()[0]
    stats = device.memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


class BandedAligner:
    """High-level batched aligner over same-shape (bucketed) pair batches.

    The DP runs as the CUDA kernel on a GPU (ops.cuda_align) and as the
    lax.scan wavefront elsewhere; both are bit-equal to each other and
    conformance-equal to oracle.align.banded_dp."""

    def __init__(self, W: int = 128, mode: str = "global"):
        self.W = W
        self.mode = mode
        self._dp = dp_for_platform(jax.default_backend())
        if self._dp is not banded_align_batch:
            from .cuda_align import check_width
            check_width(W)

    def max_inflight(self, P: int, Lq: int, Lt: int) -> int:
        """In-flight chunk bound for (P, Lq, Lt) chunks: each holds its
        (Dmax, P, W) backpointers plus the traceback's transposed copy."""
        chunk = 2 * (Lq + Lt + 1) * P * self.W + 2 * P * (Lq + Lt)
        return inflight_limit(chunk, device_bytes_limit())

    def __call__(self, q: np.ndarray, t: np.ndarray,
                 n: np.ndarray, m: np.ndarray, want_moves: bool = True):
        """q (P, Lq), t (P, Lt) int8; n, m true lengths. Returns dict of
        numpy arrays: dist, end_i, end_j [, moves list of forward arrays]."""
        return self.collect(self.dispatch(q, t, n, m, want_moves=want_moves))

    def dispatch(self, q: np.ndarray, t: np.ndarray,
                 n: np.ndarray, m: np.ndarray, want_moves: bool = True):
        """Issue the device program WITHOUT blocking on results.

        JAX dispatch is async, so callers batching many chunks should
        dispatch them all first and then ``collect`` in order — uploads,
        kernels and downloads of consecutive chunks overlap instead of
        paying a full device round trip per chunk.  The handle holds only
        small per-pair scalars plus 2-bit packed traceback moves; the big
        (Dmax, P, W) backpointer tensor is consumed on device here."""
        P, Lq = q.shape
        Lt = t.shape[1]
        Dmax, lo = build_schedule(Lq, Lt, self.W)
        # the DP runs Dmax antidiagonals, but cells past d = n + m are
        # masked-inert padding: truncate to the chunk's true need,
        # quantized to 1024 (band_lo depends only on (d, W), so the
        # schedule prefix is unchanged)
        need = int(np.max(np.asarray(n) + np.asarray(m))) + 1 if P else Dmax
        Dmax = min(Dmax, -(-need // 1024) * 1024)
        lo = lo[:Dmax]
        steps = Dmax - 1
        qg, trg, G = prepare_batch(q, t, self.W)
        res = self._dp(jnp.asarray(qg), jnp.asarray(trg), jnp.asarray(n),
                       jnp.asarray(m), jnp.asarray(lo), W=self.W, Lt=Lt,
                       G=G, mode=self.mode, want_bp=bool(want_moves))
        handle = {"res": None, "steps": steps, "combined": None,
                  "summary": None}
        if want_moves == "summary":
            moves_rev = traceback_batch(
                res["bp"], jnp.asarray(lo),
                res["end_i"], res["end_j"], max_steps=steps)
            handle["summary"] = _summarize_moves(
                moves_rev, res["dist"], res["end_i"], res["end_j"])
        elif want_moves:
            moves_rev = traceback_batch(
                res["bp"], jnp.asarray(lo),
                res["end_i"], res["end_j"], max_steps=steps)
            # ONE device array per chunk: packed moves + the 3 scalar
            # columns, so collect() costs a single device-to-host copy
            handle["combined"] = _combine_results(
                pack_moves2(moves_rev), res["dist"], res["end_i"],
                res["end_j"])
        else:
            handle["res"] = {k: v for k, v in res.items() if k != "bp"}
        return handle

    @staticmethod
    def collect_summaries(handles: list) -> dict:
        """Materialize MANY summary-mode handles with ONE device fetch.

        Summaries are (P, 7) int32 regardless of bucket shape, so every
        pending chunk's summary concatenates on device and downloads in
        one copy.  Rows follow handle order; the caller slices by its
        per-chunk P."""
        parts = [h["summary"] for h in handles]
        if not parts:
            return {"dist": np.zeros(0, np.int32)}
        s = np.asarray(jnp.concatenate(parts, axis=0))
        return {"dist": s[:, 0], "end_j": s[:, 1], "n_t": s[:, 2],
                "lead": s[:, 3], "trail": s[:, 4], "n_up": s[:, 5],
                "end_i": s[:, 6]}

    def collect(self, handle) -> dict:
        """Materialize a ``dispatch`` handle as numpy (blocks)."""
        if handle["summary"] is not None:
            s = np.asarray(handle["summary"])
            return {"dist": s[:, 0].copy(), "end_j": s[:, 1].copy(),
                    "n_t": s[:, 2].copy(), "lead": s[:, 3].copy(),
                    "trail": s[:, 4].copy(), "n_up": s[:, 5].copy(),
                    "end_i": s[:, 6].copy()}
        if handle["combined"] is not None:
            c = np.asarray(handle["combined"])
            out = {"dist": c[:, -3].copy(), "end_i": c[:, -2].copy(),
                   "end_j": c[:, -1].copy()}
            moves_rev = unpack_moves2(c[:, :-3], handle["steps"])
            out["moves"] = moves_forward(moves_rev)
            return out
        return {k: np.asarray(v) for k, v in handle["res"].items()}
