"""Multi-host initialization + host-role helpers.

Role parity: the reference's multi-node story is pwatcher submitting jobs
to SGE/Slurm over a shared filesystem (SURVEY.md §1 L7).  Here multi-host
is jax.distributed: every host runs the same program, the global mesh
spans all hosts' devices, and XLA hands the collectives to NCCL (NVLink
within a host, the network across hosts).  No scheduler integration is
needed — launch one process per host (Slurm, mpirun, a job set) and
call ``initialize()``.

Host-side division of labor (SURVEY.md §2c):
- every host parses its shard of the read inputs (data-parallel IO),
- device programs run SPMD over the global mesh,
- host 0 gathers final FASTA emission (``is_primary_host``).
"""
from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed from args or standard env vars.

    Env fallbacks: JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID (also auto-detected by jax itself on the clusters it
    recognises when no args are given).  With no args, no env and no
    recognised cluster (single-machine runs, incl. the CPU test mesh and
    a one-host GPU machine), this sets up an explicit one-process world
    on a free localhost port instead of letting jax error out.
    """
    import jax
    from jax._src import distributed as _dist
    if getattr(_dist.global_state, "client", None) is not None:
        return      # already initialized (drivers call this idempotently)
    ca = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    np_ = num_processes or _int_env("JAX_NUM_PROCESSES")
    pid = process_id if process_id is not None else _int_env("JAX_PROCESS_ID")
    if ca:
        jax.distributed.initialize(coordinator_address=ca,
                                   num_processes=np_, process_id=pid)
    else:
        try:
            jax.distributed.initialize()   # cluster auto-detect
        except ValueError:
            import socket
            with socket.socket() as s:     # grab a free local port
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            jax.distributed.initialize(
                coordinator_address=f"localhost:{port}",
                num_processes=1, process_id=0)
    logger.info("jax.distributed up: process %d/%d, %d local / %d global "
                "devices", jax.process_index(), jax.process_count(),
                jax.local_device_count(), jax.device_count())


def _int_env(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def is_primary_host() -> bool:
    import jax
    return jax.process_index() == 0


def process_count() -> int:
    import jax
    return jax.process_count()


def host_shard(n_items: int) -> tuple[int, int]:
    """[start, end) slice of n_items owned by this host (contiguous)."""
    import jax
    p = jax.process_index()
    np_ = jax.process_count()
    per = -(-n_items // np_)
    return min(p * per, n_items), min((p + 1) * per, n_items)


def barrier(tag: str) -> None:
    """Block until every process reaches this point (driver boundaries:
    host k must not read host 0's canonical artifacts mid-write)."""
    import jax
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils as mhu
    mhu.sync_global_devices(tag)


def sync_stage_done(done: bool) -> bool:
    """Make a Stage skip/run decision identical on every host.

    Host 0's checkpoint state is authoritative (it owns the canonical
    artifacts; other hosts write scratch) — if the decisions diverged,
    the host that runs the stage would block in its first collective
    while the skipping host never joins, deadlocking the job.
    """
    import jax
    if jax.process_count() == 1:
        return done
    import numpy as np
    from jax.experimental import multihost_utils as mhu
    flag = mhu.broadcast_one_to_all(np.asarray([1 if done else 0], np.int32))
    return bool(int(flag[0]))


def allgather_bytes(payload: bytes) -> list[bytes]:
    """Gather one bytes blob per process, returned in process order.

    The host-shard merge primitive: each host serializes the records it
    computed for its input shard; every host receives all shards and
    reconstructs the full (canonically re-sorted) record set.  Rides the
    jax.distributed channels as the device collectives (multihost_utils).
    """
    import jax
    if jax.process_count() == 1:
        return [payload]
    import numpy as np
    from jax.experimental import multihost_utils as mhu
    lens = mhu.process_allgather(np.asarray([len(payload)], np.int64))
    lens = np.asarray(lens).reshape(-1)
    cap = max(int(lens.max()), 1)
    buf = np.zeros(cap, np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    stacked = np.asarray(mhu.process_allgather(buf))
    stacked = stacked.reshape(jax.process_count(), cap)
    return [stacked[i, : int(lens[i])].tobytes()
            for i in range(jax.process_count())]


def exchange_to_owners(blobs: list[bytes]) -> list[bytes]:
    """All-to-all byte exchange: ``blobs[d]`` is this host's payload for
    destination host d; returns the payloads every host addressed to
    SELF, in source-process order.

    This is the record-regroup primitive of the contig-owner dataflow
    (SURVEY.md §2c all_to_all row): after host-sharded alignment each
    host routes its records to the owner of their contig instead of
    every host merging everything.  Implementation: one allgather round
    per destination, retaining only the round addressed to this host —
    total bytes moved match the old full allgather, but each host's
    RETAINED working set drops from O(genome) to O(owned contigs), and
    the transient per-round buffer is O(total / n_hosts).
    """
    import jax
    P = jax.process_count()
    if P == 1:
        return [blobs[0]]
    assert len(blobs) == P, (len(blobs), P)
    me = jax.process_index()
    mine: list[bytes] = []
    for dest in range(P):
        got = allgather_bytes(blobs[dest])
        if dest == me:
            mine = got
    return mine


def gather_to_primary(payload: bytes) -> list[bytes] | None:
    """Gather one blob per host; only host 0 returns the list (others
    return None and retain nothing).  Collective — every host must call."""
    got = allgather_bytes(payload)
    return got if is_primary_host() else None


def contig_owners(lengths, n_hosts: int):
    """Deterministic length-balanced contig -> owner-host partition.

    Greedy LPT bin packing over contig lengths (ties and assignment order
    fixed by contig index), so every host derives the identical map with
    no communication.  Returns (n_ctg,) int32 of host ids.
    """
    import numpy as np
    lengths = np.asarray(lengths, np.int64)
    owners = np.zeros(len(lengths), np.int32)
    if n_hosts <= 1:
        return owners
    order = np.argsort(-lengths, kind="stable")   # longest first
    load = [0] * n_hosts
    for ci in order:
        h = int(np.argmin(load))                  # first least-loaded host
        owners[ci] = h
        load[h] += int(lengths[ci])
    return owners


def pack_arrays(cols: dict) -> bytes:
    """A dict of numpy arrays as ``.npz`` bytes (dtype + shape kept)."""
    import io

    import numpy as np
    buf = io.BytesIO()
    np.savez(buf, **{k: np.ascontiguousarray(v) for k, v in cols.items()})
    return buf.getvalue()


def unpack_arrays(blob: bytes) -> dict:
    import io

    import numpy as np
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
