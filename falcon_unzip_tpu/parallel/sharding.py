"""Sharded device programs: multi-chip phasing + polish steps.

Role parity: the reference's ONLY multi-node mechanism is pwatcher job
fan-out over a shared filesystem (SURVEY.md §1 L7).  The rebuild replaces
it with SPMD device programs over a ('data', 'window') mesh
(BASELINE.json north star):

- phase step : read tag batches are data-parallel across every device;
  per-contig pileup counts and the banded SNP association table are
  merged with psum over the mesh; het calling is computed replicated.
- polish step: (variant x read) pair-HMM scoring pairs are sharded across
  devices (the contig-window axis analogue); log-likelihoods stay sharded
  for the host gather.

Both are shard_map programs — XLA inserts the (NCCL) collectives.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.pairhmm import forward_core

ALL = ("data", "window")


def make_phase_step(mesh: Mesh, *, t_len: int, s_cap: int, max_span: int,
                    min_depth: int = 10, min_allele_count: int = 2,
                    allele_freq_min: float = 0.25,
                    biallelic_frac: float = 0.8):
    """Sharded phasing device program.

    Inputs (sharded over all mesh devices on the read axis):
      tagpos, tagbase: (R, T) int32, -1-padded delta-0 tags per read.
    Outputs:
      counts (t_len, 5) replicated;  is_het (t_len,) replicated;
      b1, b2 (t_len,) replicated;  score/cov (s_cap, max_span) replicated;
      M (R, s_cap) int8 sharded allele matrix.
    """

    def step(tagpos, tagbase):
        R_loc, T = tagpos.shape
        # ---- pileup (scatter-add) + psum merge over the whole mesh
        pos = tagpos.reshape(-1)
        base = tagbase.reshape(-1)
        ok = (pos >= 0) & (pos < t_len)
        p = jnp.where(ok, pos, t_len)
        counts_loc = jnp.zeros((t_len + 1, 5), jnp.int32)
        counts_loc = counts_loc.at[p, jnp.clip(base, 0, 4)].add(1)
        counts = jax.lax.psum(counts_loc[:t_len], ALL)

        # ---- het predicate (replicated compute)
        depth = counts.sum(axis=1)
        bc = counts[:, :4]
        b1 = jnp.argmax(bc, axis=1)
        c1 = jnp.take_along_axis(bc, b1[:, None], axis=1)[:, 0]
        bc2 = bc.at[jnp.arange(t_len), b1].set(-1)
        b2 = jnp.argmax(bc2, axis=1)
        c2 = jnp.take_along_axis(bc2, b2[:, None], axis=1)[:, 0]
        c12 = c1 + c2
        thresh = jnp.maximum(min_allele_count,
                             jnp.ceil(allele_freq_min * c12).astype(jnp.int32))
        is_het = ((depth >= min_depth) & (c2 >= thresh)
                  & (c12 >= biallelic_frac * depth))

        # ---- allele matrix for local reads (first s_cap sites)
        site_of_pos = jnp.where(is_het, jnp.cumsum(is_het) - 1, -1)
        site_of_pos = jnp.where(site_of_pos < s_cap, site_of_pos, -1)
        site = jnp.where(ok, site_of_pos[jnp.clip(pos, 0, t_len - 1)], -1)
        hit = site >= 0
        sb1 = b1[jnp.clip(pos, 0, t_len - 1)]
        sb2 = b2[jnp.clip(pos, 0, t_len - 1)]
        val = jnp.where(base == sb1, 1,
                        jnp.where(base == sb2, -1, 0)).astype(jnp.int8)
        rows = jnp.repeat(jnp.arange(R_loc, dtype=jnp.int32), T)
        M = jnp.zeros((R_loc, s_cap + 1), jnp.int8)
        M = M.at[rows, jnp.where(hit, site, s_cap)].set(
            jnp.where(hit, val, 0))
        M = M[:, :s_cap]

        # ---- banded association, psum-merged
        Mi = M.astype(jnp.int32)
        Mpad = jnp.pad(Mi, ((0, 0), (0, max_span + 1)))

        def assoc(_, d):
            sh = jax.lax.dynamic_slice(Mpad, (0, d), (R_loc, s_cap))
            prod = Mi * sh
            return None, (prod.sum(axis=0), jnp.abs(prod).sum(axis=0))

        _, (score_loc, cov_loc) = jax.lax.scan(
            assoc, None, jnp.arange(1, max_span + 1, dtype=jnp.int32))
        score = jax.lax.psum(score_loc.T, ALL)
        cov = jax.lax.psum(cov_loc.T, ALL)
        return counts, is_het, b1.astype(jnp.int8), b2.astype(jnp.int8), \
            score, cov, M

    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(P(ALL, None), P(ALL, None)),
        out_specs=(P(), P(), P(), P(), P(), P(), P(ALL, None)))
    return jax.jit(sharded)


def make_polish_step(mesh: Mesh, *, W: int, Lt: int, G: int):
    """Sharded pair-HMM scoring: pairs split across all devices."""

    def step(qg, trg, n, m, lo_arr, params_vec):
        return forward_core(qg, trg, n, m, lo_arr, params_vec,
                            W=W, Lt=Lt, G=G)

    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(P(ALL, None), P(ALL, None), P(ALL), P(ALL), P(None), P(None)),
        out_specs=P(ALL))
    return jax.jit(sharded)


# ---------------------------------------------------------------------------
# Pipeline-facing sharded executors (config-5: full pipeline over a mesh)
# ---------------------------------------------------------------------------

def _pad_to(x, mult, fill):
    pad = (-len(x)) % mult
    if pad == 0:
        return x
    return np.concatenate([x, np.full(pad, fill, x.dtype)])


def _global_rows(full: np.ndarray, mesh: Mesh, spec: P):
    """Build the global row-sharded jax.Array for `full`.

    Single process: a device_put with the named sharding.  Multi-process
    (jax.distributed): every host holds the identical `full` (host
    compute is replicated by construction); each process uploads ONLY its
    contiguous row slice via make_array_from_process_local_data — mesh
    device order is jax.devices() order (process-major), so process p
    owns rows [p*per, (p+1)*per).  This is what makes the shard_map
    programs true multi-HOST programs (SURVEY.md §2c cluster fan-out).
    """
    import jax
    from jax.sharding import NamedSharding
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1 or _mesh_is_local(mesh):
        return jax.device_put(full, sharding)
    per = full.shape[0] // jax.process_count()
    p = jax.process_index()
    local = np.ascontiguousarray(full[p * per:(p + 1) * per])
    return jax.make_array_from_process_local_data(sharding, local,
                                                  full.shape)


def _global_repl(full: np.ndarray, mesh: Mesh):
    """Fully-replicated global array (every process supplies the value)."""
    import jax
    from jax.sharding import NamedSharding
    sharding = NamedSharding(mesh, P())
    if jax.process_count() == 1 or _mesh_is_local(mesh):
        return jax.device_put(full, sharding)
    return jax.make_array_from_process_local_data(sharding, full,
                                                  full.shape)


def _mesh_is_local(mesh: Mesh) -> bool:
    """True when every mesh device belongs to THIS process (the
    contig-owner dataflow's per-host local mesh): plain device_put works
    and make_array_from_process_local_data must not be used."""
    import jax
    me = jax.process_index()
    return all(d.process_index == me for d in mesh.devices.flat)


def _bucket(n: int, mult: int) -> int:
    """Round n up to mult * next_pow2 so jit shape cache stays small."""
    per = -(-max(n, 1) // mult)
    p = 1
    while p < per:
        p <<= 1
    return mult * p


class ShardedPhaseOps:
    """Mesh data-parallel pileup + allele-association with EXACT integer
    semantics — results are bit-identical to the single-device ops
    (scatter-adds and psum are integer, order-free).

    This is what makes the 3-unzip stage a true multi-chip program: flat
    read tags are split over every device, each shard scatter-adds its
    pileup/association partials, and one psum over ('data','window')
    merges them (the SURVEY.md §2c "collectives" row).
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        self._pileup_cache: dict[int, object] = {}
        self._assoc_cache: dict[int, object] = {}

    def _pileup_fn(self, t_len: int):
        if t_len not in self._pileup_cache:
            @jax.jit
            @functools.partial(
                shard_map, mesh=self.mesh, in_specs=(P(ALL), P(ALL)),
                out_specs=P())
            def _pileup(pos, base):
                ok = (pos >= 0) & (pos < t_len)
                p = jnp.where(ok, pos, t_len)
                counts = jnp.zeros((t_len + 1, 5), jnp.int32)
                counts = counts.at[p, jnp.clip(base, 0, 4)].add(1)
                return jax.lax.psum(counts[:t_len], ALL)

            self._pileup_cache[t_len] = _pileup
        return self._pileup_cache[t_len]

    def _assoc_fn(self, max_span: int):
        if max_span not in self._assoc_cache:
            @jax.jit
            @functools.partial(
                shard_map, mesh=self.mesh, in_specs=(P(ALL, None),),
                out_specs=(P(), P()))
            def _assoc(M):
                rows, n_sites = M.shape
                Mi = M.astype(jnp.int32)
                Mpad = jnp.pad(Mi, ((0, 0), (0, max_span + 1)))

                def step(_, d):
                    sh = jax.lax.dynamic_slice(Mpad, (0, d),
                                               (rows, n_sites))
                    prod = Mi * sh
                    return None, (prod.sum(axis=0),
                                  jnp.abs(prod).sum(axis=0))

                _, (score, cov) = jax.lax.scan(
                    step, None,
                    jnp.arange(1, max_span + 1, dtype=jnp.int32))
                return (jax.lax.psum(score.T.astype(jnp.int32), ALL),
                        jax.lax.psum(cov.T.astype(jnp.int32), ALL))

            self._assoc_cache[max_span] = _assoc
        return self._assoc_cache[max_span]

    def pileup(self, pos, base, *, t_len: int) -> np.ndarray:
        pos = np.asarray(pos, np.int32)
        base = np.asarray(base, np.int32)
        B = _bucket(len(pos), self.n_dev)
        gp = _global_rows(_pad_to(pos, B, -1), self.mesh, P(ALL))
        gb = _global_rows(_pad_to(base, B, 0), self.mesh, P(ALL))
        out = np.asarray(self._pileup_fn(t_len)(gp, gb))
        from . import debug
        if debug.enabled():
            from ..ops.pileup import pileup_scatter
            debug.check_spec("pileup.pos", gp, P(ALL))
            debug.check_equal(
                "pileup", out,
                np.asarray(pileup_scatter(pos, base, t_len=t_len)))
        return out

    def association(self, M, *, max_span: int):
        M0 = np.asarray(M, np.int8)
        M = M0
        B = _bucket(M.shape[0], self.n_dev)
        pad = B - M.shape[0]
        if pad:  # zero rows contribute nothing to score or cov
            M = np.concatenate([M, np.zeros((pad, M.shape[1]), np.int8)])
        score, cov = self._assoc_fn(max_span)(
            _global_rows(M, self.mesh, P(ALL, None)))
        score, cov = np.asarray(score), np.asarray(cov)
        from . import debug
        if debug.enabled():
            from ..ops.association import association_band_device
            rs, rc = association_band_device(M0, max_span=max_span)
            debug.check_equal("association.score", score, rs)
            debug.check_equal("association.cov", cov, rc)
        return score, cov


class ShardedPairHMMScorer:
    """Drop-in PairHMMScorer that splits scoring pairs across the mesh.

    Same (q, t, n, m) -> ll interface as ops.pairhmm.PairHMMScorer;
    the pair axis is sharded over
    ('data','window') and each device runs the banded forward on its
    shard (the polish stage's multi-chip path, SURVEY.md §2c).
    """

    def __init__(self, mesh: Mesh, W: int = 64, params=None):
        from ..ops.pairhmm import params_vector
        self.mesh = mesh
        self.W = W
        self.pvec = params_vector(params)
        self.n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        self._jit_cache = {}

    def _step(self, Lt: int, G: int):
        key = (Lt, G)
        if key not in self._jit_cache:
            mesh, W = self.mesh, self.W

            @jax.jit
            @functools.partial(
                shard_map, mesh=mesh,
                in_specs=(P(ALL, None), P(ALL, None), P(ALL), P(ALL),
                          P(None), P(None)),
                out_specs=P(),
                # the all_gather over every mesh axis makes the output
                # truly replicated; the VMA checker can't infer that
                check_vma=False)
            def step(qg, trg, n, m, lo_arr, pvec):
                ll = forward_core(qg, trg, n, m, lo_arr, pvec,
                                  W=W, Lt=Lt, G=G)
                # gather shards -> replicated so every HOST of a
                # multi-process mesh reads the full result locally
                return jax.lax.all_gather(ll, ALL, tiled=True)

            self._jit_cache[key] = step
        return self._jit_cache[key]

    def __call__(self, q: np.ndarray, t: np.ndarray,
                 n: np.ndarray, m: np.ndarray) -> np.ndarray:
        from ..ops.pairhmm import build_schedule, prepare_batch
        Pn, Lq = q.shape
        Lt = t.shape[1]
        B = _bucket(Pn, self.n_dev)
        pad = B - Pn
        if pad:  # repeat last pair; padded lanes are dropped after gather
            q = np.concatenate([q, np.tile(q[-1:], (pad, 1))])
            t = np.concatenate([t, np.tile(t[-1:], (pad, 1))])
            n = np.concatenate([n, np.tile(n[-1:], pad)])
            m = np.concatenate([m, np.tile(m[-1:], pad)])
        qg, trg, G = prepare_batch(q, t, self.W)
        Dmax, lo = build_schedule(Lq, Lt, self.W)
        mesh = self.mesh
        ll = self._step(Lt, G)(
            _global_rows(np.asarray(qg), mesh, P(ALL, None)),
            _global_rows(np.asarray(trg), mesh, P(ALL, None)),
            _global_rows(np.asarray(n), mesh, P(ALL)),
            _global_rows(np.asarray(m), mesh, P(ALL)),
            _global_repl(np.asarray(lo), mesh),
            _global_repl(np.asarray(self.pvec), mesh))
        out = np.asarray(ll)[:Pn]
        from . import debug
        if debug.enabled():
            from ..ops.pairhmm import forward_core
            import functools as _ft
            import jax as _jax
            ref = np.asarray(_jax.jit(_ft.partial(
                forward_core, W=self.W, Lt=Lt, G=G))(
                    jnp.asarray(qg[:Pn]), jnp.asarray(trg[:Pn]),
                    jnp.asarray(n[:Pn]), jnp.asarray(m[:Pn]),
                    jnp.asarray(lo), jnp.asarray(self.pvec)))
            debug.check_equal("pairhmm.ll", out, ref, atol=1e-4)
        return out


class ShardedArrowSplicer:
    """Mesh-sharded ops.arrow.ArrowSplicer (the polish hot loop).

    Same (qs, ts, cands, pvecs) -> (ll_cur, ll_mut) interface; the
    (read, window) pair axis is sharded over ('data', 'window') and each
    device runs forward+backward+splice on its shard; results are
    all_gather'd to replicated so every host reads them locally
    (SURVEY.md §2c polish row).
    """

    def __init__(self, mesh: Mesh, max_cand: int = 8, params=None,
                 chunk: int = 512, fixed_lq: int | None = None,
                 fixed_lj: int | None = None,
                 tier_params: np.ndarray | None = None):
        from ..ops.arrow import ArrowSplicer
        self._base = ArrowSplicer(max_cand=max_cand, params=params,
                                  chunk=chunk, fixed_lq=fixed_lq,
                                  fixed_lj=fixed_lj,
                                  tier_params=tier_params)
        self._base._dispatch = self._dispatch
        self._base._pick_chunk = self._pick_chunk
        self.C = max_cand
        self.mesh = mesh
        self.n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        self._jit_cache = {}

    def _pick_chunk(self, N: int) -> int:
        # both candidates are n_dev-divisible so shards stay equal
        return min(_bucket(N, self.n_dev),
                   _bucket(self._base.chunk, self.n_dev))

    def _fn(self, Lq: int, LJ: int, tiered: bool):
        key = (Lq, LJ, tiered)
        if key not in self._jit_cache:
            from ..ops.arrow import arrow_splice_core
            mesh, C = self.mesh, self.C
            specs = (P(ALL, None), P(ALL, None), P(ALL), P(ALL),
                     P(ALL, None), P(ALL, None))
            if tiered:
                # qtier shards with the pair axis; the tier table is
                # small and replicated
                specs = specs + (P(ALL, None), P())

            @jax.jit
            @functools.partial(
                shard_map, mesh=mesh, in_specs=specs,
                out_specs=(P(), P()),
                # all_gather over every axis -> truly replicated; the
                # VMA checker can't infer that
                check_vma=False)
            def step(q, t, n, m, cand, pvec, qt=None, tiers=None):
                cur, mut = arrow_splice_core(q, t, n, m, cand, pvec,
                                             qt, tiers,
                                             Lq=Lq, LJ=LJ, C=C)
                return (jax.lax.all_gather(cur, ALL, tiled=True),
                        jax.lax.all_gather(mut, ALL, tiled=True))

            self._jit_cache[key] = step
        return self._jit_cache[key]

    def _dispatch(self, qa, ta, nn, mm, ca, pv, Lq: int, LJ: int,
                  qt=None):
        mesh = self.mesh
        args = [
            _global_rows(np.asarray(qa), mesh, P(ALL, None)),
            _global_rows(np.asarray(ta), mesh, P(ALL, None)),
            _global_rows(np.asarray(nn), mesh, P(ALL)),
            _global_rows(np.asarray(mm), mesh, P(ALL)),
            _global_rows(np.asarray(ca), mesh, P(ALL, None)),
            _global_rows(np.asarray(pv), mesh, P(ALL, None))]
        if qt is not None:
            args.append(_global_rows(np.asarray(qt), mesh, P(ALL, None)))
            args.append(jnp.asarray(self._base.tier_params))
        out = self._fn(Lq, LJ, qt is not None)(*args)
        from . import debug
        if debug.enabled():
            from ..ops.arrow import arrow_splice_batch
            ref = arrow_splice_batch(
                jnp.asarray(qa), jnp.asarray(ta), jnp.asarray(nn),
                jnp.asarray(mm), jnp.asarray(ca), jnp.asarray(pv),
                None if qt is None else jnp.asarray(qt),
                None if qt is None
                else jnp.asarray(self._base.tier_params),
                Lq=Lq, LJ=LJ, C=self.C)
            debug.check_equal("arrow.ll_cur", np.asarray(out[0]),
                              np.asarray(ref[0]), atol=1e-3)
            debug.check_equal("arrow.ll_mut", np.asarray(out[1]),
                              np.asarray(ref[1]), atol=1e-3)
        return out

    def __call__(self, qs, ts, cands, pvecs=None, qtiers=None):
        return self._base(qs, ts, cands, pvecs=pvecs, qtiers=qtiers)


class ShardedWindowVotes:
    """Window-axis (sequence-parallel) vote-tensor construction.

    The contig TEMPLATE axis is sharded over the mesh 'window' axis —
    the CP/SP analogue of SURVEY.md §2c row 6: each window shard
    scatter-adds the votes of its template segment from the data-sharded
    flat tag stream (psum over 'data' merges the read shards), and a
    ring ppermute halo exchange (parallel.collectives.make_halo_exchange)
    ships each shard's leading `halo` columns to its left neighbor.
    Every polish window [lo, lo+window) is then sliced entirely from the
    extended block of the shard owning `lo` — the host never rebuilds
    the full contig vote tensor, and the scatter work is distributed
    over the whole mesh.  Integer scatter-add + psum keep the result
    bit-identical to ops.consensus.vote_matrix.
    """

    def __init__(self, mesh: Mesh, max_delta: int | None = None):
        from ..oracle.consensus import MAX_DELTA
        self.mesh = mesh
        self.nw = int(mesh.shape["window"])
        self.nd = int(mesh.shape["data"])
        self.D = (MAX_DELTA if max_delta is None else max_delta) + 1
        self._scatter_cache: dict[int, object] = {}
        self._halo_cache: dict[tuple[int, int], object] = {}

    def supports(self, t_len: int, window: int) -> bool:
        """The halo covers exactly one right neighbor, so each segment
        must be at least one polish window long."""
        return self.nw > 1 and -(-t_len // self.nw) >= window

    def _scatter_fn(self, seg: int):
        if seg not in self._scatter_cache:
            D = self.D

            @jax.jit
            @functools.partial(
                shard_map, mesh=self.mesh,
                in_specs=(P("data"), P("data"), P("data")),
                out_specs=P("window", None, None))
            def _scatter(pos, delta, base):
                w = jax.lax.axis_index("window")
                lp = pos - w * seg
                ok = (lp >= 0) & (lp < seg) & (delta < D) & (pos >= 0)
                p = jnp.where(ok, lp, seg)
                v = jnp.zeros((seg + 1, D, 5), jnp.int32)
                v = v.at[p, jnp.clip(delta, 0, D - 1),
                         jnp.clip(base, 0, 4)].add(1)
                return jax.lax.psum(v[:seg], "data")

            self._scatter_cache[seg] = _scatter
        return self._scatter_cache[seg]

    def _halo_fn(self, seg: int, halo: int):
        key = (seg, halo)
        if key not in self._halo_cache:
            from .collectives import make_halo_exchange
            self._halo_cache[key] = make_halo_exchange(self.mesh, halo=halo)
        return self._halo_cache[key]

    def blocks(self, pos, delta, base, *, t_len: int, window: int):
        """Build per-shard vote blocks for a contig.

        pos/delta/base: flat int32 tag columns (pos < 0 rows ignored).
        Returns (blocks (nw, seg+window, D, 5) np.ndarray, seg).
        """
        pos = np.asarray(pos, np.int32)
        delta = np.asarray(delta, np.int32)
        base = np.asarray(base, np.int32)
        seg = -(-t_len // self.nw)
        B = _bucket(len(pos), self.nd)
        g = lambda x, fill: _global_rows(_pad_to(x, B, fill), self.mesh,
                                         P("data"))
        votes = self._scatter_fn(seg)(g(pos, -1), g(delta, 0), g(base, 0))
        flat = votes.reshape(self.nw * seg, self.D * 5)
        _left, right = self._halo_fn(seg, window)(flat)
        v_np = np.asarray(votes).reshape(self.nw, seg, self.D, 5)
        r_np = np.asarray(right).reshape(self.nw, window, self.D, 5)
        blocks = np.concatenate([v_np, r_np], axis=1)
        from . import debug
        if debug.enabled():
            from ..ops.consensus import vote_matrix
            tags = np.stack([pos, delta, base], axis=1)
            ref = vote_matrix([tags], t_len)
            full = v_np.reshape(self.nw * seg, self.D, 5)[:t_len]
            debug.check_equal("window_votes", full, ref)
        return blocks, seg


def make_pipeline_mesh(n_devices: int = 0, window_par: int = 0,
                       local_only: bool = False):
    """Mesh for the pipeline drivers: None when only one device is visible
    (single-chip path) or when n_devices == 1 (explicitly disabled).

    local_only: mesh over THIS PROCESS's devices only — the contig-owner
    dataflow runs each host's per-contig device programs independently
    (no cross-host collectives inside them), so the mesh must not span
    processes."""
    if n_devices == 1:
        return None
    devs = jax.local_devices() if local_only else jax.devices()
    avail = len(devs)
    n = min(n_devices, avail) if n_devices else avail
    if n < 2:
        return None
    from .mesh import make_mesh
    if local_only:
        import numpy as np
        wp = window_par or (2 if (n % 2 == 0 and n > 2) else 1)
        arr = np.array(devs[:n]).reshape(n // wp, wp)
        return Mesh(arr, axis_names=("data", "window"))
    return make_mesh(n, window_par or None)
