"""Banded Baum-Welch training on the GPU kernels (float32).

The exact-parity path (`ops/nt_banded_batch.banded_batch_train`, ref:
src/cpp/NT_banded.cpp:303-451) runs the whole update as XLA scans plus
scatter-adds; it stays the CPU/fp64 path and the oracle here. This module
computes the same per-read estimates from the Triton kernels of
ops/nt_banded_pallas:

  1. `forward` stores fM/fE and returns Zf;
  2. `backward` with the fE store folds the m1/e2 transition numerators
     into per-read sums of exp(term - Zf) while it runs — no (T, B) score
     tensor is built, and Zf cancels in the normalization;
  3. `emission_position_sums` turns the posterior weights into weighted
     moment sums per sequence position: rows are summed by band start (a
     (T, V) one-hot of the band start against the (3, T, B) weights, one
     matmul per read at full fp32 precision; it measured 69 ms against
     78 ms for a segment sum over t for 24 x 16k reads on an H100), and
     the (band column, band start) table is collapsed onto positions
     n = start + column - 1 along its anti-diagonals by a pad/reshape
     shear. Three channels (w, w*y, w*y^2, y the per-read-centred
     signal) give the moments; the per-k-mer reduction is a segment sum
     over k-mer ids (`kmer_moments`).

Parity with the scan path is covered by tests/test_train_fast.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from dynamont_jax.ops import nt_banded_batch as bb
from dynamont_jax.ops import nt_banded_pallas as pk


def emission_position_sums(batch: bb.BandedBatch, forM, forE, backM, backE,
                           Zb, N_stat: int):
    """Per-position posterior-weight moment sums (norm, w*y, w*y^2).

    Returns (norm, wy, wy2, s0): each (R, N_stat), s0 (R,) the per-read
    signal mean the y channel is centred on. Equals the scan path's
    scatter-adds (ref trainEmission gather, NT_banded.cpp:374-451).
    """
    R, Tm1 = batch.sig.shape
    T_pad = Tm1 + 1
    B = batch.B
    # band starts can be negative (the band hangs below position 0 near
    # t=0); shift them by B so the start axis covers [-B, N_stat+1]
    V = N_stat + B + 2

    T_f = batch.T.astype(jnp.float32)
    s0 = jnp.sum(batch.sig.astype(jnp.float32), axis=1) / jnp.maximum(
        T_f - 1.0, 1.0)
    # row t holds sig[t-1]
    sig_rows = jnp.pad(batch.sig.astype(jnp.float32), ((0, 0), (1, 0)))
    t_ar = jnp.arange(T_pad)
    j_ar = jnp.arange(B)

    def per_read(r):
        w = (jnp.exp(forM[r] + backM[r] - Zb[r])
             + jnp.exp(forE[r] + backE[r] - Zb[r]))
        bs = batch.bstart[r]
        n = bs[:, None] - 1 + j_ar[None, :]
        valid = ((t_ar[:, None] >= 1) & (t_ar[:, None] < batch.T[r])
                 & (n >= 0) & (n < batch.N[r]))
        w = jnp.nan_to_num(jnp.where(valid, w, 0.0), nan=0.0, posinf=0.0)
        y = (sig_rows[r] - s0[r])[:, None]
        ch = jnp.stack([w, w * y, w * y * y], axis=0)          # (3, T, B)
        S = jax.nn.one_hot(bs + B, V, dtype=jnp.float32)       # (T, V)
        M = jnp.einsum("ktb,tv->kbv", ch, S,
                       precision=jax.lax.Precision.HIGHEST)    # (3, B, V)
        # anti-diagonal shear: q[p] = sum_j M[j, p-j]; n = (v-B) - 1 + j
        # = p - B - 1, so position n lives at q[n + B + 1]
        Mp = jnp.pad(M, ((0, 0), (0, 0), (0, B)))               # (3, B, V+B)
        flat = Mp.reshape(3, B * (V + B))[:, : B * (V + B - 1)]
        q = flat.reshape(3, B, V + B - 1).sum(axis=1)           # (3, V+B-1)
        return q[:, B + 1: B + 1 + N_stat]

    sums = jax.lax.map(per_read, jnp.arange(R))                 # (R, 3, N_stat)
    return sums[:, 0], sums[:, 1], sums[:, 2], s0


def _kmer_reduce(vals, kid_pad, pos_live, num_kmers):
    """Sum over positions of vals grouped by k-mer id: (R, N_stat-1) ->
    (R, K). A segment sum: 0.07 ms against 0.16 ms for the one-hot matmul
    at 24 reads on an H100."""
    vals = jnp.where(pos_live, vals, 0.0)
    return jax.vmap(lambda v, k: jax.ops.segment_sum(
        v, k, num_segments=num_kmers))(vals, kid_pad)


def kmer_moments(norm, wy, wy2, s0, kmer_ids_pad, N, num_kmers):
    """Per-read k-mer level means, stdevs and mask from the per-position
    moment sums of `emission_position_sums` (the scan path's rule, ref:
    NT_banded.cpp:374-451: a position's mean is its weighted signal mean, a
    k-mer's mean the average over its positions, its variance likewise
    about the new k-mer mean).

    A k-mer counts where its positions carry posterior weight. The scan
    path asks for a positive stdev instead, which is the same in exact
    arithmetic: a position's weight sums its dwell (>= 1 sample). But where
    the weight sits on one sample (a base squeezed to a single sample, as
    at the end of a read whose signal runs out), the true variance is
    ~1e-9, and the fp32 recombination below cancels it to 0: the stdev
    rule would drop the read's estimate of that k-mer from the fp32 pool
    while fp64 keeps it (PERF.md)."""
    R = norm.shape[0]
    N_stat = norm.shape[1]
    has = norm > 0
    safe_norm = jnp.where(has, norm, 1.0)
    pos_mean = jnp.where(has, s0[:, None] + wy / safe_norm, 0.0)

    pos_live = jnp.arange(N_stat - 1)[None, :] < (N[:, None] - 1)
    counts = _kmer_reduce(jnp.ones_like(kmer_ids_pad, jnp.float32),
                          kmer_ids_pad, pos_live, num_kmers)
    safe_counts = jnp.where(counts > 0, counts, 1.0)
    means = _kmer_reduce(pos_mean[:, 1:], kmer_ids_pad, pos_live,
                         num_kmers) / safe_counts

    # variance about the NEW k-mer means, recombined per position:
    # sum w*(sig-mb)^2 = wy2 - 2*mbc*wy + mbc^2*norm with mbc = mb - s0
    mb_rest = jnp.take_along_axis(means, kmer_ids_pad, axis=1)
    mean_by_pos = jnp.concatenate(
        [jnp.zeros((R, 1), means.dtype), mb_rest], axis=1)
    mbc = mean_by_pos - s0[:, None]
    var_sum = jnp.maximum(wy2 - 2.0 * mbc * wy + mbc * mbc * norm, 0.0)
    pos_var = jnp.where(has, var_sum / safe_norm, 0.0)
    stdevs = jnp.sqrt(
        _kmer_reduce(pos_var[:, 1:], kmer_ids_pad, pos_live, num_kmers)
        / safe_counts)
    weight = _kmer_reduce(norm[:, 1:], kmer_ids_pad, pos_live, num_kmers)
    kmer_mask = (counts > 0) & (weight > 0)
    return means, stdevs, kmer_mask


def banded_batch_train_fast(batch: bb.BandedBatch, log_m1, log_e2,
                            kmer_ids_pad, num_kmers,
                            interpret: bool = False) -> bb.BandedTrainResult:
    """The kernels' equivalent of `banded_batch_train` (float32).

    Jitted with the transitions as traced arguments: successive training
    batches with updated m1/e2 (and bucketed shapes) reuse the compile.
    """
    return _train_fast_jit(
        batch.sig, batch.mu_pad, batch.c1_pad, batch.c2_pad, batch.bstart,
        batch.T, batch.N, batch.bw, kmer_ids_pad,
        jnp.asarray(log_m1, jnp.float32), jnp.asarray(log_e2, jnp.float32),
        pad=batch.pad, B=batch.B, num_kmers=int(num_kmers),
        interpret=bool(interpret),
    )


@functools.partial(jax.jit,
                   static_argnames=("pad", "B", "num_kmers", "interpret"))
def _train_fast_jit(sig, mu_pad, c1_pad, c2_pad, bstart, T, N, bw,
                    kmer_ids_pad, log_m1, log_e2, *, pad, B, num_kmers,
                    interpret):
    batch = bb.BandedBatch(sig, mu_pad, c1_pad, c2_pad, bstart, T, N, bw,
                           pad, B)
    return banded_batch_train_kernels(batch, log_m1, log_e2, kmer_ids_pad,
                                      num_kmers, interpret)


def banded_batch_train_kernels(batch, log_m1, log_e2, kmer_ids_pad,
                               num_kmers, interpret=False):
    """Traceable body of `banded_batch_train_fast` (also the shard body of
    parallel/train_step)."""
    forM, forE, Zf = pk.forward(batch, log_m1, log_e2, interpret)
    backM, backE, Zb, acc = pk.backward(batch, log_m1, log_e2, interpret,
                                        fe=forE, zf=Zf)
    tot = acc[:, 0] + acc[:, 1]
    live = tot > 0
    safe_tot = jnp.where(live, tot, 1.0)
    m1 = jnp.where(live, acc[:, 0] / safe_tot, 0.0)
    e2 = jnp.where(live, acc[:, 1] / safe_tot, 0.0)

    N_stat = kmer_ids_pad.shape[1] + 1
    norm, wy, wy2, s0 = emission_position_sums(
        batch, forM, forE, backM, backE, Zb, N_stat)
    means, stdevs, kmer_mask = kmer_moments(norm, wy, wy2, s0, kmer_ids_pad,
                                            batch.N, num_kmers)
    return bb.BandedTrainResult(
        Zf=Zf, Zb=Zb, m1=m1, e2=e2,
        means=means, stdevs=stdevs, kmer_mask=kmer_mask,
    )
