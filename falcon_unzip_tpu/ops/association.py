"""Device SNP-pair association + read phase votes (scan + matmuls).

Role parity: [U] falcon_unzip/phasing.py::generate_association_table and
get_phased_reads (SURVEY.md §3.2 steps 2 & 4).  Re-design: the pairwise
co-occurrence table is BANDED (site pairs within max_span) and computed as
a lax.scan of shifted elementwise products — one (n_reads, n_sites)
multiply-reduce per offset; the per-read block votes are two matmuls
against a block one-hot.

Determinism: integer arithmetic throughout; matches oracle.phasing
bit-for-bit.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("max_span",))
def association_band_device(M, *, max_span: int):
    """M: (n_reads, n_sites) int8 -> (score, cov) each (n_sites, max_span).

    score[s, d] = sum_r M[r,s] * M[r,s+d+1];  cov = count of both-observed.
    """
    n_reads, n_sites = M.shape
    Mi = M.astype(jnp.int32)
    Mpad = jnp.pad(Mi, ((0, 0), (0, max_span + 1)))

    def step(_, d):
        shifted = jax.lax.dynamic_slice(Mpad, (0, d), (n_reads, n_sites))
        prod = Mi * shifted
        return None, (prod.sum(axis=0), jnp.abs(prod).sum(axis=0))

    _, (score, cov) = jax.lax.scan(
        step, None, jnp.arange(1, max_span + 1, dtype=jnp.int32))
    return score.T.astype(jnp.int32), cov.T.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("max_span",))
def association_band_batch(M, *, max_span: int):
    """Batched banded association for G contigs in one program.

    M: (G, n_reads, n_sites) int8.  Returns (score, cov) each
    (G, n_sites, max_span) int32; per-contig slices equal
    association_band_device bit-for-bit (integer sums are order-free).
    """
    G, n_reads, n_sites = M.shape
    Mi = M.astype(jnp.int32)
    Mpad = jnp.pad(Mi, ((0, 0), (0, 0), (0, max_span + 1)))

    def step(_, d):
        shifted = jax.lax.dynamic_slice(Mpad, (0, 0, d),
                                        (G, n_reads, n_sites))
        prod = Mi * shifted
        return None, (prod.sum(axis=1), jnp.abs(prod).sum(axis=1))

    _, (score, cov) = jax.lax.scan(
        step, None, jnp.arange(1, max_span + 1, dtype=jnp.int32))
    # (max_span, G, n_sites) -> (G, n_sites, max_span)
    return (score.transpose(1, 2, 0).astype(jnp.int32),
            cov.transpose(1, 2, 0).astype(jnp.int32))


@jax.jit
def read_block_votes_batch(M, block_onehot, sgn):
    """Batched per-read block votes: (G, R, S) x (G, S, B) -> (G, R, B).

    Same exact-integer-in-f32 matmul semantics as read_block_votes, with
    a leading contig-group axis (one batched matmul per group).
    """
    Mf = M.astype(jnp.float32)
    oh = block_onehot.astype(jnp.float32)
    votes = jnp.einsum("grs,gsb->grb", Mf * sgn.astype(jnp.float32)[:, None, :],
                       oh, preferred_element_type=jnp.float32)
    covs = jnp.einsum("grs,gsb->grb", jnp.abs(Mf), oh,
                      preferred_element_type=jnp.float32)
    return votes.astype(jnp.int32), covs.astype(jnp.int32)


@jax.jit
def read_block_votes(M, block_onehot, sgn):
    """Per-read per-block vote and coverage via matmuls.

    M: (n_reads, n_sites) int8;  block_onehot: (n_sites, n_blocks) int8
    (1 where site belongs to block);  sgn: (n_sites,) int32 in {-1,+1}
    (+1 where the site's b1 allele is block hap0).

    Returns (votes, covs): (n_reads, n_blocks) int32.
    """
    Mf = M.astype(jnp.float32)
    oh = block_onehot.astype(jnp.float32)
    votes = jnp.dot(Mf * sgn.astype(jnp.float32)[None, :], oh,
                    preferred_element_type=jnp.float32)
    covs = jnp.dot(jnp.abs(Mf), oh, preferred_element_type=jnp.float32)
    return votes.astype(jnp.int32), covs.astype(jnp.int32)


def assign_reads(votes: np.ndarray, covs: np.ndarray):
    """Pick each read's block/phase (oracle.phase_reads semantics)."""
    votes = np.asarray(votes)
    covs = np.asarray(covs)
    n_reads, n_blocks = votes.shape
    r_block = np.full(n_reads, -1, np.int64)
    r_phase = np.full(n_reads, -1, np.int8)
    if n_blocks == 0:
        return r_block, r_phase
    best_b = np.argmax(covs, axis=1)               # ties -> smaller block id
    best_cov = covs[np.arange(n_reads), best_b]
    v = votes[np.arange(n_reads), best_b]
    ok = (best_cov > 0) & (v != 0)
    r_block[ok] = best_b[ok]
    r_phase[ok] = np.where(v[ok] > 0, 0, 1)
    return r_block, r_phase
