"""Sharded Baum-Welch training step: data-parallel over the "reads" mesh axis.

Each device runs the banded forward/backward + per-read parameter estimation
for its shard of the padded batch; batch-pooled statistics are merged with
psum across the cards. This replaces the reference's per-read C++ child processes +
host-side ManagedList pooling (ref: train.py:211,236-247) with one SPMD
program.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dynamont_jax.ops import nt_banded_batch as bb
from dynamont_jax.parallel.mesh import READS_AXIS


class PooledStats(NamedTuple):
    """Batch-pooled training statistics (replicated across devices)."""

    m1_sum: jax.Array       # scalar: sum of per-read m1 estimates over valid reads
    e2_sum: jax.Array
    n_valid: jax.Array      # scalar: number of reads passing the Z invariant
    mean_sum: jax.Array     # (K,) sum over contributing reads of per-read kmer mean
    stdev_sum: jax.Array    # (K,) same for stdevs
    kmer_count: jax.Array   # (K,) number of contributing reads per kmer
    z_sum: jax.Array        # scalar: sum of per-read Z over valid reads


class ShardedTrainOut(NamedTuple):
    per_read: bb.BandedTrainResult  # gathered along reads
    pooled: PooledStats             # replicated


def make_sharded_train_step(mesh: Mesh, m1: float, e2: float, num_kmers: int,
                            pad: int, B: int, dtype=jnp.float32):
    """Build the jitted SPMD training step for a fixed bucket shape.

    Inputs are the BandedBatch arrays (+ per-position kmer ids), sharded on
    their leading reads axis; R must be divisible by the mesh size. The
    shard body is the GPU kernels' training pass (ops/nt_banded_train)
    where ops/nt_banded_pallas.kernels_enabled says so, the exact scan
    path otherwise.
    """
    from dynamont_jax.ops import nt_banded_pallas as pk
    from dynamont_jax.ops.nt_banded_train import banded_batch_train_kernels

    log_m1_0, log_e2_0 = math.log(m1), math.log(e2)
    axis = mesh.axis_names[0]
    eps = bb.z_epsilon(dtype)
    kernels = pk.kernels_enabled(dtype)

    def shard_fn(sig, mu_pad, c1_pad, c2_pad, bstart, T, N, bw, kmer_ids_pad,
                 log_m1, log_e2):
        batch = bb.BandedBatch(sig, mu_pad, c1_pad, c2_pad, bstart, T, N, bw, pad, B)
        if kernels:
            res = banded_batch_train_kernels(
                batch, log_m1, log_e2, kmer_ids_pad, num_kmers)
        else:
            res = bb.banded_batch_train(
                batch, log_m1, log_e2, kmer_ids_pad, num_kmers)
        cells = T.astype(res.Zf.dtype) * B
        ok = (
            jnp.isfinite(res.Zf) & jnp.isfinite(res.Zb)
            & (jnp.abs(res.Zf - res.Zb) / cells <= eps)
            & (T > 1)  # degenerate rows are reads-axis padding, not data
        )
        okf = ok.astype(res.m1.dtype)
        contrib = res.kmer_mask & ok[:, None]
        cf = contrib.astype(res.means.dtype)
        pooled = PooledStats(
            m1_sum=jax.lax.psum(jnp.sum(res.m1 * okf), axis),
            e2_sum=jax.lax.psum(jnp.sum(res.e2 * okf), axis),
            n_valid=jax.lax.psum(jnp.sum(okf), axis),
            mean_sum=jax.lax.psum(jnp.sum(res.means * cf, axis=0), axis),
            stdev_sum=jax.lax.psum(jnp.sum(res.stdevs * cf, axis=0), axis),
            kmer_count=jax.lax.psum(jnp.sum(cf, axis=0), axis),
            z_sum=jax.lax.psum(jnp.sum(jnp.where(ok, res.Zb, 0.0)), axis),
        )
        return ShardedTrainOut(res, pooled)

    sharded = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
                  P(axis), P(axis), P(), P()),
        out_specs=ShardedTrainOut(
            per_read=bb.BandedTrainResult(
                Zf=P(axis), Zb=P(axis), m1=P(axis), e2=P(axis),
                means=P(axis), stdevs=P(axis), kmer_mask=P(axis),
            ),
            pooled=PooledStats(*(P() for _ in PooledStats._fields)),
        ),
        # the DP scan carries are constructed from constants inside the
        # sharded region; skip the varying-manual-axes check rather than
        # thread pcast through every kernel
        check_vma=False,
    )

    jitted = jax.jit(sharded)
    fdt = jnp.dtype(dtype)

    def step(batch: bb.BandedBatch, kmer_ids_pad,
             m1_cur: float | None = None,
             e2_cur: float | None = None) -> ShardedTrainOut:
        """Run one step; m1_cur/e2_cur override the construction-time
        transitions WITHOUT recompiling (they enter as traced scalars)."""
        lm = log_m1_0 if m1_cur is None else math.log(m1_cur)
        le = log_e2_0 if e2_cur is None else math.log(e2_cur)
        return jitted(
            batch.sig, batch.mu_pad, batch.c1_pad, batch.c2_pad, batch.bstart,
            batch.T, batch.N, batch.bw, kmer_ids_pad,
            jnp.asarray(lm, fdt), jnp.asarray(le, fdt),
        )

    return step


def pool_params(pooled: PooledStats):
    """Batch-mean parameter update from pooled stats (host-side; equivalent of
    setting each param to the ManagedList window mean, ref: train.py:236-247)."""
    n = float(pooled.n_valid)
    if n == 0:
        return None
    out = {
        "m1": float(pooled.m1_sum) / n,
        "e1": 1.0,
        "e2": float(pooled.e2_sum) / n,
        "Z": float(pooled.z_sum) / n,
    }
    import numpy as np

    count = np.asarray(pooled.kmer_count, dtype=np.float64)
    safe = np.where(count > 0, count, 1.0)
    out["kmer_means"] = np.asarray(pooled.mean_sum, dtype=np.float64) / safe
    out["kmer_stdevs"] = np.asarray(pooled.stdev_sum, dtype=np.float64) / safe
    out["kmer_seen"] = count > 0
    return out


def shard_batch_for_mesh(batch: bb.BandedBatch, kmer_ids_pad, mesh: Mesh):
    """Pad the reads dimension to a multiple of the mesh size and place every
    array with its reads axis sharded over the mesh."""
    import numpy as np

    n_dev = mesh.devices.size
    R = batch.sig.shape[0]
    R_pad = ((R + n_dev - 1) // n_dev) * n_dev
    extra = R_pad - R

    def pad_r(a):
        a = np.asarray(a)
        if extra == 0:
            return a
        widths = [(0, extra)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, widths)

    arrays = {
        "sig": pad_r(batch.sig),
        "mu_pad": pad_r(batch.mu_pad),
        "c1_pad": pad_r(batch.c1_pad),
        "c2_pad": pad_r(batch.c2_pad),
        "bstart": pad_r(batch.bstart),
        "T": pad_r(batch.T),
        "N": pad_r(batch.N),
        "bw": pad_r(batch.bw),
    }
    # padded rows must still be well-formed DP problems; give them T=N=1
    if extra:
        arrays["T"][R:] = 1
        arrays["N"][R:] = 1
        arrays["bw"][R:] = np.maximum(arrays["bw"][R:], 1)
    spec = NamedSharding(mesh, P(mesh.axis_names[0]))
    put = lambda a: jax.device_put(a, spec)
    new_batch = bb.BandedBatch(
        sig=put(arrays["sig"]), mu_pad=put(arrays["mu_pad"]),
        c1_pad=put(arrays["c1_pad"]), c2_pad=put(arrays["c2_pad"]),
        bstart=put(arrays["bstart"]), T=put(arrays["T"]), N=put(arrays["N"]),
        bw=put(arrays["bw"]), pad=batch.pad, B=batch.B,
    )
    kmer_ids_pad = put(pad_r(kmer_ids_pad))
    return new_batch, kmer_ids_pad, R
