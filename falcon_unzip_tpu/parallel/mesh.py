"""Device mesh construction for the unzip dataflow.

Role parity: the reference has NO in-process distributed runtime — its
"mesh" is a batch scheduler + shared filesystem (SURVEY.md §1 L7, §2c).
Here the equivalents are explicit jax.sharding meshes:

  axis 'data'   — read-batch data parallelism (replaces pwatcher job
                  fan-out over cluster nodes)
  axis 'window' — contig-window sharding, the sequence-parallel analogue
                  (replaces per-contig task fan-out / GenomicConsensus
                  windowing)

Multi-host: the same mesh spans hosts via jax.distributed.initialize();
XLA hands the collectives to NCCL: NVLink between the cards of a host
(all to all, so the mesh follows the algorithm, not a physical torus),
the network across hosts.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None,
              window_par: int | None = None) -> Mesh:
    """Build a ('data', 'window') mesh over the first n devices.

    window_par defaults to 2 when n is even and > 2 (so both axes are
    exercised), else 1.
    """
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    if window_par is None:
        window_par = 2 if (n % 2 == 0 and n > 2) else 1
    assert n % window_par == 0
    arr = np.array(devs).reshape(n // window_par, window_par)
    return Mesh(arr, axis_names=("data", "window"))


def data_sharding(mesh: Mesh, *rest) -> NamedSharding:
    """Rows sharded over BOTH mesh axes (full data-parallel layout)."""
    return NamedSharding(mesh, P(("data", "window"), *rest))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
