"""Collective building blocks: read regrouping + window halo exchange.

Role parity (SURVEY.md §2c):
- the reference's `max_n_open_files` two-stage BAM partition becomes an
  `all_to_all` regroup of reads to their contig-owner device;
- GenomicConsensus window-overlap stitching becomes a ring `ppermute`
  halo exchange over the contig-window ("sequence") axis.

Both are shard_map programs over the ('data', 'window') mesh from
parallel.mesh; XLA lowers them to NCCL collectives.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

ALL = ("data", "window")


def make_regroup(mesh: Mesh, *, cap: int, feat: int):
    """Regroup rows to owner devices over the flattened mesh axis.

    Input  (per shard): payload (R_loc, feat) int32, owner (R_loc,) int32
      (owner in [0, n_dev); rows with owner -1 are dropped).
    Output (per shard): recv (n_dev, cap, feat) int32 + counts (n_dev,)
      — rows this device now owns, grouped by source shard, -1 padded.
    cap bounds rows sent PER (src, dst) pair; overflow is counted in
    ``dropped`` so callers can re-run with a larger cap.
    """
    n_dev = int(np.prod([mesh.shape[a] for a in ALL]))

    def step(payload, owner):
        R_loc = payload.shape[0]
        # bucket rows by destination with capacity cap
        send = jnp.full((n_dev, cap, feat), -1, jnp.int32)
        slot_of = jnp.zeros((R_loc,), jnp.int32)
        # per-destination running slot via sort-free scan
        def body(i, carry):
            send, counts, dropped = carry
            d = owner[i]
            ok = (d >= 0) & (counts[jnp.maximum(d, 0)] < cap)
            di = jnp.maximum(d, 0)
            slot = jnp.minimum(counts[di], cap - 1)
            send = send.at[di, slot].set(
                jnp.where(ok, payload[i], send[di, slot]))
            counts = jnp.where(ok, counts.at[di].add(1), counts)
            dropped = dropped + jnp.where((d >= 0) & ~ok, 1, 0)
            return send, counts, dropped

        # mark literal-constant carries as varying over the manual axes
        # (the new shard_map type system otherwise rejects the loop carry)
        init = jax.tree.map(
            lambda x: jax.lax.pcast(x, ALL, to="varying"),
            (send, jnp.zeros((n_dev,), jnp.int32), jnp.int32(0)))
        send, counts, dropped = jax.lax.fori_loop(0, R_loc, body, init)
        # all_to_all: axis 0 of send is the destination device
        recv = jax.lax.all_to_all(send, ALL, split_axis=0, concat_axis=0,
                                  tiled=False)
        recv_counts = jax.lax.all_to_all(
            counts.reshape(n_dev, 1), ALL, split_axis=0, concat_axis=0,
            tiled=False).reshape(n_dev)
        return recv, recv_counts, dropped.reshape(1)

    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(P(ALL, None), P(ALL)),
        out_specs=(P(ALL, None, None), P(ALL), P(ALL)))
    return jax.jit(sharded)


def regroup_partition(ctg_ids: np.ndarray, n_groups: int,
                      mesh: Mesh | None = None) -> list[np.ndarray]:
    """Partition row indices by group (contig) id through the mesh
    all_to_all regroup — the production entry of make_regroup.

    Role parity: the reference's two-stage `max_n_open_files` BAM
    partition (SURVEY.md §2c row 5) — each read's record is routed to
    its contig-owner device (owner = ctg % n_dev) by the shard_map
    all_to_all; the returned per-group row lists are read back from the
    owner shards and restored to input order, so consumers emit
    byte-identical partitions to a host scan.

    Returns a list of n_groups int64 index arrays.  Falls back to a
    host groupby when fewer than 2 devices are visible.
    """
    import jax

    ctg_ids = np.asarray(ctg_ids, np.int64)
    n = len(ctg_ids)
    if mesh is None and len(jax.devices()) >= 2:
        from .mesh import make_mesh
        mesh = make_mesh()
    if mesh is None or n == 0:
        return [np.nonzero(ctg_ids == g)[0] for g in range(n_groups)]

    n_dev = int(np.prod([mesh.shape[a] for a in ALL]))
    rows_per_shard = -(-n // n_dev)
    pad = n_dev * rows_per_shard - n
    payload = np.stack([np.arange(n, dtype=np.int64),
                        ctg_ids], axis=1).astype(np.int32)
    owner = np.where(ctg_ids >= 0, ctg_ids % n_dev, -1).astype(np.int32)
    if pad:
        payload = np.concatenate(
            [payload, np.full((pad, 2), -1, np.int32)])
        owner = np.concatenate([owner, np.full(pad, -1, np.int32)])

    cap = max(8, 2 * rows_per_shard)
    while True:
        recv, counts, dropped = make_regroup(mesh, cap=cap, feat=2)(
            payload, owner)
        if int(np.asarray(dropped).sum()) == 0:
            break
        cap *= 2          # capacity overflow: retry with a larger cap
    recv = np.asarray(recv).reshape(n_dev, n_dev, cap, 2)
    counts = np.asarray(counts).reshape(n_dev, n_dev)
    groups: list[list[np.ndarray]] = [[] for _ in range(n_groups)]
    for dst in range(n_dev):
        for src in range(n_dev):
            rows = recv[dst, src, : counts[dst, src]]
            for g in range(dst, n_groups, n_dev):
                sel = rows[:, 1] == g
                if sel.any():
                    groups[g].append(rows[sel, 0].astype(np.int64))
    return [np.sort(np.concatenate(g)) if g else
            np.zeros(0, np.int64) for g in groups]


def make_halo_exchange(mesh: Mesh, *, halo: int):
    """Ring halo exchange over the 'window' axis.

    x (per shard): (L_loc, F) — returns (halo, F) left ghost and
    (halo, F) right ghost from the neighboring window shards (zeros at
    the ring ends' wrap, which callers mask).
    """
    nw = mesh.shape["window"]

    def step(x):
        left_edge = x[:halo]          # goes to left neighbor's right ghost
        right_edge = x[-halo:]        # goes to right neighbor's left ghost
        perm_fwd = [(i, (i + 1) % nw) for i in range(nw)]
        perm_bwd = [(i, (i - 1) % nw) for i in range(nw)]
        left_ghost = jax.lax.ppermute(right_edge, "window", perm_fwd)
        right_ghost = jax.lax.ppermute(left_edge, "window", perm_bwd)
        return left_ghost, right_ghost

    sharded = shard_map(
        step, mesh=mesh,
        in_specs=P("window", None),
        out_specs=(P("window", None), P("window", None)))
    return jax.jit(sharded)
