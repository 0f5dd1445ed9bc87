"""Batched banded NT DP as XLA scans — the CPU and fp64 path, and the
reference the GPU kernels (ops/nt_banded_pallas) are tested against.

Reads are padded to a common (T_pad, B) bucket and processed as one jitted
program: a `lax.scan` over signal time whose per-step body is elementwise work
on a (batch, B) tile — the wavefront t-loop stays sequential (inherent DP
dependency, ref: src/cpp/NT_banded.cpp forward/backward), while the band and
batch dimensions vectorize onto the VPU. Per-read band geometry (bstart per
row, bandwidth, true T/N) rides along as traced scalars/arrays so one compiled
program serves every read in a bucket.

Differences from the exact-parity single-read path (ops/nt_banded.py):
  * default dtype float32; the Z invariant threshold scales with the dtype
    (see z_epsilon).
  * outputs are posterior *probabilities* PM/PE plus the Viterbi choice
    bits — exactly what the traceback walk consumes — instead of the four
    raw matrices. In fp32 the probabilities are for+back normalized per row
    (see row_lse); fp64 keeps the reference's global Z.

The band width B is padded to a power of two (see band_width), the block
shape the GPU kernels need; B is the minor-most dimension throughout.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dynamont_jax.constants import EPSILON
from dynamont_jax.ops.geometry import band_geometry, effective_bandwidth

NEG_INF = -jnp.inf

def z_epsilon(dtype) -> float:
    """Per-cell forward/backward agreement tolerance.

    The reference demands abs(Zf-Zb)/cells <= 1e-8 in double precision
    (ref: utils.cpp:7, NT_banded_main.cpp:156). In float32 the rounding
    noise accumulated over T logaddexp steps reaches ~1 in absolute Z for
    production-length reads, so the per-cell threshold is relaxed by 100x —
    loose enough for fp32 noise (|dZ| bound ~10 at T=16k, B=512), tight
    enough to catch genuinely broken DPs (mismatched band geometry, wrong
    shifts) which blow up by many orders of magnitude.
    """
    if jnp.dtype(dtype) == jnp.float64:
        return EPSILON
    return 1e-6


class BandedBatch(NamedTuple):
    """Device-ready padded batch. R reads, T_pad rows, B band columns."""

    sig: jax.Array        # (R, T_pad-1) normalized signal, zero padded
    mu_pad: jax.Array     # (R, N_pad) per-position emission mean, index n-1+pad
    c1_pad: jax.Array     # (R, N_pad) -0.5*log(2pi) - log(sd)
    c2_pad: jax.Array     # (R, N_pad) 0.5 / sd^2
    bstart: jax.Array     # (R, T_pad) int32 band start per row (midpoint - bw)
    T: jax.Array          # (R,) int32 true T = len(sig)+1
    N: jax.Array          # (R,) int32 true N = n_kmers+1
    bw: jax.Array         # (R,) int32 per-read effective bandwidth
    pad: int              # static param-array left padding
    B: int                # static band array width (>= 2*max_bw+3)


class BandedBatchResult(NamedTuple):
    Zf: jax.Array       # (R,)
    Zb: jax.Array       # (R,)
    PM: jax.Array       # (R, T_pad, B) posterior probability of M
    PE: jax.Array       # (R, T_pad, B) posterior probability of E
    choices: jax.Array  # (R, T_pad, B) bool Viterbi traceback bit


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def band_width(max_bw: int) -> int:
    """Band array width: 2*max_bw+3 cells (ref: NT_banded.cpp:269-287)
    padded to a power of two."""
    return 1 << (2 * max_bw + 2).bit_length()


def prepare_batch(
    signals: list[np.ndarray],
    kmer_ids_list: list[np.ndarray],
    means: np.ndarray,
    stdevs: np.ndarray,
    band: int = 400,
    dtype=jnp.float32,
    t_pad_to: int = 256,
    n_pad_to: int = 1,
) -> BandedBatch:
    """Pad a list of reads into one device batch.

    Geometry (bstart per row) is computed on host with the same float64
    midpoint truncation as the reference (ref: NT_banded.cpp:269-287).
    """
    R = len(signals)
    T_arr = np.array([len(s) + 1 for s in signals], dtype=np.int32)
    N_arr = np.array([len(k) + 1 for k in kmer_ids_list], dtype=np.int32)
    bw_arr = np.array(
        [effective_bandwidth(band, int(n)) for n in N_arr], dtype=np.int32
    )
    max_bw = int(bw_arr.max())
    B = band_width(max_bw)
    pad = max_bw + 3
    T_pad = round_up(int(T_arr.max()), t_pad_to)
    # extra +B tail so every dynamic_slice window fits without clamping
    # (XLA clamps out-of-range starts, which would silently shift windows);
    # n_pad_to buckets the position extent so varying-length batches reuse
    # compiled programs
    N_pad = round_up(int(N_arr.max()) - 1, n_pad_to) + 2 * pad + B

    log2pi = 1.8378770664093453
    np_dtype = np.dtype(jnp.dtype(dtype).name)

    sig = np.zeros((R, T_pad - 1), dtype=np_dtype)
    mu_pad = np.zeros((R, N_pad), dtype=np_dtype)
    c1_pad = np.zeros((R, N_pad), dtype=np_dtype)
    c2_pad = np.zeros((R, N_pad), dtype=np_dtype)
    bstart = np.zeros((R, T_pad), dtype=np.int32)
    for i, (s, kid) in enumerate(zip(signals, kmer_ids_list)):
        T, N, bw = int(T_arr[i]), int(N_arr[i]), int(bw_arr[i])
        sig[i, : T - 1] = s
        mu = means[kid]
        sd = stdevs[kid]
        mu_pad[i, pad : pad + N - 1] = mu
        c1_pad[i, pad : pad + N - 1] = -0.5 * log2pi - np.log(sd)
        c2_pad[i, pad : pad + N - 1] = 0.5 / (sd * sd)
        geom = band_geometry(T, N, bw)
        bstart[i, :T] = geom.bstart
        bstart[i, T:] = geom.bstart[T - 1]  # frozen past the true end: shift 0
    return BandedBatch(
        sig=jnp.asarray(sig),
        mu_pad=jnp.asarray(mu_pad),
        c1_pad=jnp.asarray(c1_pad),
        c2_pad=jnp.asarray(c2_pad),
        bstart=jnp.asarray(bstart),
        T=jnp.asarray(T_arr),
        N=jnp.asarray(N_arr),
        bw=jnp.asarray(bw_arr),
        pad=pad,
        B=B,
    )


def _shift_left(row, fill):
    return jnp.concatenate([row[1:], jnp.full((1,), fill, row.dtype)])


def _shift_right(row, fill):
    return jnp.concatenate([jnp.full((1,), fill, row.dtype), row[:-1]])


def _band_scores(mu_pad, c1_pad, c2_pad, sig_t, start, B):
    mu = jax.lax.dynamic_slice(mu_pad, (start,), (B,))
    c1 = jax.lax.dynamic_slice(c1_pad, (start,), (B,))
    c2 = jax.lax.dynamic_slice(c2_pad, (start,), (B,))
    d = sig_t - mu
    return c1 - c2 * d * d


def _valid_mask(j_iota, bs, bw, N, lower_from_one: bool):
    """valid j range: n in [max(lower, bstart), min(bstart+2bw+1, N)) mapped to
    band columns, where lower is 1 (forward/viterbi rows t>=1) or 0."""
    ns = jnp.maximum(bs, 1 if lower_from_one else 0)
    ne = jnp.minimum(bs + 2 * bw + 1, N)
    j_lo = ns - bs + 1
    j_hi = ne - bs + 1
    return (j_iota >= j_lo) & (j_iota < j_hi)


def _forward_single(batch: BandedBatch, log_m1, log_e2, idx_dtype=jnp.int32):
    """Forward pass for one (padded) read; returns (M, E) of shape (T_pad, B).

    The emission-parameter band window slides by at most one position per
    step, so instead of a dynamic slice per step the window rides in the
    scan carry and the single entering element per step is bulk-gathered
    outside the scan.

    Rows past the true T are garbage (never read: Z and traceback index by
    the true T). Written to be vmapped over the batch dimension.
    """

    def fn(sig, mu_pad, c1_pad, c2_pad, bstart, bw, N):
        B = batch.B
        dtype = sig.dtype
        j_iota = jnp.arange(B, dtype=idx_dtype)

        # entering (right-edge) window element per row t — one bulk gather.
        # window(t) = params[bstart[t]-2+pad : bstart[t]-2+pad+B]
        enter_idx = bstart + (B - 2 + batch.pad - 1)
        e_mu = mu_pad[enter_idx]
        e_c1 = c1_pad[enter_idx]
        e_c2 = c2_pad[enter_idx]

        def step(carry, xs):
            M_prev, E_prev, wmu, wc1, wc2 = carry
            sig_t, s1, em, ec1, ec2, bs = xs
            slide = lambda w, e: jnp.where(
                s1, jnp.concatenate([w[1:], e[None]]), w
            )
            wmu = slide(wmu, em)
            wc1 = slide(wc1, ec1)
            wc2 = slide(wc2, ec2)
            d = sig_t - wmu
            sc_b = wc1 - wc2 * d * d
            E_m = jnp.where(s1, E_prev, _shift_right(E_prev, NEG_INF))
            M_e = jnp.where(s1, _shift_left(M_prev, NEG_INF), M_prev)
            E_e = jnp.where(s1, _shift_left(E_prev, NEG_INF), E_prev)
            M_new = E_m + sc_b + log_m1
            E_new = jnp.logaddexp(M_e + sc_b, E_e + sc_b + log_e2)
            valid = _valid_mask(j_iota, bs, bw, N, lower_from_one=True)
            M_new = jnp.where(valid, M_new, NEG_INF)
            E_new = jnp.where(valid, E_new, NEG_INF)
            return (M_new, E_new, wmu, wc1, wc2), (M_new, E_new)

        M0 = jnp.full((B,), NEG_INF, dtype)
        E0 = M0.at[bw + 1].set(0.0)
        w0 = lambda arr: jax.lax.dynamic_slice(
            arr, (bstart[0] - 2 + batch.pad,), (B,)
        )
        s_flags = bstart[1:] != bstart[:-1]
        xs = (sig, s_flags, e_mu[1:], e_c1[1:], e_c2[1:], bstart[1:])
        carry0 = (M0, E0, w0(mu_pad), w0(c1_pad), w0(c2_pad))
        _, (Ms, Es) = jax.lax.scan(step, carry0, xs)
        return (
            jnp.concatenate([M0[None], Ms], axis=0),
            jnp.concatenate([E0[None], Es], axis=0),
        )

    return fn


def _backward_single(batch: BandedBatch, log_m1, log_e2, idx_dtype=jnp.int32):
    """Backward pass for one padded read. The terminal condition lives at the
    *true* t = T-1 (E = 0 at the band center); rows above are kept at -inf so
    the reverse scan passes through the padding as a no-op."""

    def fn(sig, mu_pad, c1_pad, c2_pad, bstart, bw, N, T):
        B = batch.B
        dtype = sig.dtype
        j_iota = jnp.arange(B, dtype=idx_dtype)
        init_row = jnp.full((B,), NEG_INF, dtype).at[bw + 1].set(0.0)

        # sliding (B+1,) window: win(t) = params[bstart[t]-2+pad : ... +B+1];
        # sc_b uses win[:B] (kmer position n-1), sc_a uses win[1:] (position
        # n). Scanning t downward the window slides LEFT, entering at index
        # bstart[t]-2+pad — bulk-gathered here.
        enter_idx = bstart + (batch.pad - 2)
        e_mu = mu_pad[enter_idx]
        e_c1 = c1_pad[enter_idx]
        e_c2 = c2_pad[enter_idx]

        def step(carry, xs):
            M_next, E_next, wmu, wc1, wc2 = carry
            sig_t, bs, s1, em, ec1, ec2, t = xs
            slide = lambda w, e: jnp.where(
                s1, jnp.concatenate([e[None], w[:-1]]), w
            )
            wmu = slide(wmu, em)
            wc1 = slide(wc1, ec1)
            wc2 = slide(wc2, ec2)
            d_b = sig_t - wmu[:B]
            sc_b = wc1[:B] - wc2[:B] * d_b * d_b
            d_a = sig_t - wmu[1:]
            sc_a = wc1[1:] - wc2[1:] * d_a * d_a
            n = bs + j_iota - 1
            E_n = jnp.where(s1, _shift_right(E_next, NEG_INF), E_next)
            M_n = jnp.where(s1, M_next, _shift_left(M_next, NEG_INF))
            ext = jnp.where(n + 1 < N, M_n + sc_a + log_m1, NEG_INF)
            has_prev = n > 0
            M_new = jnp.where(has_prev, E_n + sc_b, NEG_INF)
            ext = jnp.where(has_prev, jnp.logaddexp(ext, E_n + sc_b + log_e2), ext)
            valid = _valid_mask(j_iota, bs, bw, N, lower_from_one=False)
            M_new = jnp.where(valid, M_new, NEG_INF)
            E_new = jnp.where(valid, ext, NEG_INF)
            # the row at the true end IS the terminal condition: everything
            # above (t >= T, the padding) stays -inf via the -inf carry.
            is_term = t == T - 1
            M_new = jnp.where(is_term, jnp.full((B,), NEG_INF, dtype), M_new)
            E_new = jnp.where(is_term, init_row, E_new)
            return (M_new, E_new, wmu, wc1, wc2), (M_new, E_new)

        T_pad = bstart.shape[0]
        t_iota = jnp.arange(T_pad - 1, dtype=idx_dtype)
        neg = jnp.full((B,), NEG_INF, dtype)
        w0 = lambda arr: jax.lax.dynamic_slice(
            arr, (bstart[T_pad - 1] - 2 + batch.pad,), (B + 1,)
        )
        s_flags = bstart[1:] != bstart[:-1]  # shift between t and t+1, at idx t
        xs = (sig, bstart[:-1], s_flags, e_mu[:-1], e_c1[:-1], e_c2[:-1], t_iota)
        carry0 = (neg, neg, w0(mu_pad), w0(c1_pad), w0(c2_pad))
        _, (Ms, Es) = jax.lax.scan(step, carry0, xs, reverse=True)
        # the stored row at the true T-1 is the terminal row itself for any
        # consumer that reads it; rows in (T-1, T_pad) are garbage.
        M = jnp.concatenate([Ms, neg[None]], axis=0)
        E = jnp.concatenate([Es, neg[None]], axis=0)
        t_all = jnp.arange(T_pad, dtype=idx_dtype)[:, None]
        M = jnp.where(t_all == T - 1, neg[None], M)
        E = jnp.where(t_all == T - 1, init_row[None], E)
        return M, E

    return fn


def _viterbi_single(batch: BandedBatch, idx_dtype=jnp.int32):
    """Max-recurrence over posterior log-probs, banded (ref:
    NT_banded.cpp:139-189). Emits the traceback predicate
    choice[t,j] = (E[t,j] == M[t-1, j+s] + LPE[t,j])."""

    def fn(LPM, LPE, bstart, bw, N):
        B = batch.B
        dtype = LPM.dtype
        j_iota = jnp.arange(B, dtype=idx_dtype)

        def step(carry, xs):
            M_prev, E_prev = carry
            lpm, lpe, bs, bs_prev = xs
            s1 = bs != bs_prev
            E_m = jnp.where(s1, E_prev, _shift_right(E_prev, NEG_INF))
            M_e = jnp.where(s1, _shift_left(M_prev, NEG_INF), M_prev)
            E_e = jnp.where(s1, _shift_left(E_prev, NEG_INF), E_prev)
            M_new = E_m + lpm
            E_new = jnp.maximum(M_e, E_e) + lpe
            valid = _valid_mask(j_iota, bs, bw, N, lower_from_one=True)
            M_new = jnp.where(valid, M_new, NEG_INF)
            E_new = jnp.where(valid, E_new, NEG_INF)
            choice = E_new == (M_e + lpe)
            return (M_new, E_new), choice

        M0 = jnp.full((B,), NEG_INF, dtype)
        E0 = M0.at[bw + 1].set(0.0)
        xs = (LPM[1:], LPE[1:], bstart[1:], bstart[:-1])
        (_, _), choices = jax.lax.scan(step, (M0, E0), xs)
        return jnp.concatenate([jnp.zeros((1, B), bool), choices], axis=0)

    return fn


def row_lse(LPM, LPE):
    """Log total of each band row's posteriors over both states (last
    axis, kept as size 1); 0 for dead rows (all -inf).

    A row's posteriors sum to 1 (the path is in one cell at each t), so
    subtracting this changes the exact values by nothing; the fp32 paths
    subtract it to remove the drift of the global normalizer: for + back
    - Zb drifts from the exact value along t by up to |Zf - Zb| (over 2e-2
    at T = 16k), while the row's own total carries only that row's
    rounding. The values are log probabilities off by at most that drift,
    so exp cannot overflow and the sum needs no max shift. fp64 keeps the
    reference's global Z (as the NTC engine does, ref: NTC_main.cpp:186)."""
    tot = (jnp.sum(jnp.exp(LPM), axis=-1, keepdims=True)
           + jnp.sum(jnp.exp(LPE), axis=-1, keepdims=True))
    return jnp.where(tot > 0, jnp.log(jnp.where(tot > 0, tot, 1.0)), 0.0)


def banded_batch_run(batch: BandedBatch, log_m1, log_e2) -> BandedBatchResult:
    """Full segmentation compute for a padded batch: forward + backward +
    posteriors + Viterbi choices. Jit over static (T_pad, B, R) shapes."""
    fwd = jax.vmap(_forward_single(batch, log_m1, log_e2))
    forM, forE = fwd(
        batch.sig, batch.mu_pad, batch.c1_pad, batch.c2_pad, batch.bstart,
        batch.bw, batch.N,
    )
    bwd = jax.vmap(_backward_single(batch, log_m1, log_e2))
    backM, backE = bwd(
        batch.sig, batch.mu_pad, batch.c1_pad, batch.c2_pad, batch.bstart,
        batch.bw, batch.N, batch.T,
    )
    R = batch.sig.shape[0]
    r_iota = jnp.arange(R)
    Zf = forE[r_iota, batch.T - 1, batch.bw + 1]
    Zb = backE[r_iota, 0, batch.bw + 1]
    LPM = forM + backM - Zb[:, None, None]
    LPE = forE + backE - Zb[:, None, None]
    # the Viterbi runs on the global-Z form (a per-row shift would cancel
    # in its max-plus recurrence anyway: every path visits every row once)
    vit = jax.vmap(_viterbi_single(batch))
    choices = vit(LPM, LPE, batch.bstart, batch.bw, batch.N)
    if LPM.dtype == jnp.float32:
        lse = row_lse(LPM, LPE)
        LPM, LPE = LPM - lse, LPE - lse
    # exp(-inf - -inf) etc. can surface NaN in dead rows, and fp32 roundoff
    # can push cells epsilon-above 1; clamp so the traceback only ever
    # sees probabilities in [0, 1].
    PM = jnp.clip(jnp.nan_to_num(jnp.exp(LPM), nan=0.0, posinf=0.0), 0.0, 1.0)
    PE = jnp.clip(jnp.nan_to_num(jnp.exp(LPE), nan=0.0, posinf=0.0), 0.0, 1.0)
    return BandedBatchResult(Zf=Zf, Zb=Zb, PM=PM, PE=PE, choices=choices)


class BandedTrainResult(NamedTuple):
    """Per-read Baum-Welch estimates for a padded batch."""

    Zf: jax.Array        # (R,)
    Zb: jax.Array        # (R,)
    m1: jax.Array        # (R,) updated transition probability
    e2: jax.Array        # (R,)
    means: jax.Array     # (R, K) per-read k-mer level means (0 where unseen)
    stdevs: jax.Array    # (R, K) per-read k-mer level stdevs (0 where unseen)
    kmer_mask: jax.Array  # (R, K) bool: read contributes this k-mer


def _logsumexp_all(x):
    m = jnp.max(x)
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    return jnp.log(jnp.sum(jnp.exp(x - m))) + m


def _train_single(batch: BandedBatch, log_m1, log_e2, num_kmers):
    """Per-read Baum-Welch update over the band (ref: NT_banded.cpp:303-451),
    padded-batch edition: rows past the true T and positions past the true N
    are masked out of every reduction.

    kmer_ids_pad: (N_max-1,) int32 per-position k-mer ids, 0-padded.
    """

    def fn(sig, mu_pad, c1_pad, c2_pad, bstart, bw, N, T, kmer_ids_pad):
        B = batch.B
        T_pad = bstart.shape[0]
        dtype = sig.dtype
        forM, forE = _forward_single(batch, log_m1, log_e2)(
            sig, mu_pad, c1_pad, c2_pad, bstart, bw, N
        )
        backM, backE = _backward_single(batch, log_m1, log_e2)(
            sig, mu_pad, c1_pad, c2_pad, bstart, bw, N, T
        )
        Zf = forE[T - 1, bw + 1]
        Zb = backE[0, bw + 1]

        j_iota = jnp.arange(B)
        t_rows = jnp.arange(T_pad - 1)  # rows 0..T_pad-2 (transition sources)
        n = bstart[:-1][:, None] + j_iota[None, :] - 1

        # shift tracker between row t and t+1 — the reference initializes its
        # tracker from bounds[0] instead of bounds[T-1] (ref:
        # NT_banded.cpp:309), so at t = T-2 the shift compares against row 0.
        # Replicated for training parity.
        s_next = (bstart[1:] != bstart[:-1])
        s_last = bstart[jnp.maximum(T - 2, 0)] != bstart[0]
        s_next = jnp.where(t_rows == T - 2, s_last, s_next)[:, None]

        def score_rows(offset):
            starts = bstart[: T_pad - 1] + offset + batch.pad

            def row(sig_t, st):
                return _band_scores(mu_pad, c1_pad, c2_pad, sig_t, st, B)

            return jax.vmap(row)(sig, starts)

        sc_a = score_rows(-1)
        sc_b = score_rows(-2)

        def roll_left(rows):
            return jnp.concatenate(
                [rows[:, 1:], jnp.full((rows.shape[0], 1), NEG_INF, dtype)], axis=1
            )

        def roll_right(rows):
            return jnp.concatenate(
                [jnp.full((rows.shape[0], 1), NEG_INF, dtype), rows[:, :-1]], axis=1
            )

        backM_next = backM[1:]
        backE_next = backE[1:]
        backM_sh = jnp.where(s_next, backM_next, roll_left(backM_next))
        backE_sh = jnp.where(s_next, roll_right(backE_next), backE_next)

        live = (t_rows[:, None] < T - 1)
        forE_rows = forE[:-1]
        m1_terms = jnp.where(
            live & (n + 1 < N), forE_rows + log_m1 + sc_a + backM_sh, NEG_INF
        )
        e2_terms = jnp.where(
            live & (n > 0), forE_rows + log_e2 + sc_b + backE_sh, NEG_INF
        )
        newM1 = _logsumexp_all(m1_terms)
        newE2 = _logsumexp_all(e2_terms)
        Ae = jnp.logaddexp(newE2, newM1)
        fin = jnp.isfinite(Ae)
        newM1 = jnp.where(fin, newM1 - Ae, newM1)
        newE2 = jnp.where(fin, newE2 - Ae, newE2)

        # ---- emission stats (ref: NT_banded.cpp:374-451) ----
        LPM = forM + backM - Zb
        LPE = forE + backE - Zb
        w = jnp.exp(LPM[1:]) + jnp.exp(LPE[1:])  # rows t = 1..T_pad-1
        n_idx = bstart[1:][:, None] + j_iota[None, :] - 1
        t_live = (jnp.arange(1, T_pad)[:, None] < T)
        valid = (n_idx >= 0) & (n_idx < N) & t_live
        w = jnp.where(valid, w, 0.0)
        w = jnp.nan_to_num(w, nan=0.0, posinf=0.0)
        N_max = kmer_ids_pad.shape[0] + 1
        n_safe = jnp.clip(n_idx, 0, N_max - 1)
        flat_idx = n_safe.reshape(-1)
        wsum_sig = jnp.zeros(N_max, dtype).at[flat_idx].add(
            (w * sig[:, None]).reshape(-1)
        )
        norm = jnp.zeros(N_max, dtype).at[flat_idx].add(w.reshape(-1))
        pos_mean = jnp.where(norm > 0, wsum_sig / jnp.where(norm > 0, norm, 1.0), 0.0)

        pos_live = jnp.arange(N_max - 1) < N - 1  # positions 0..N-2 are real
        kid = jnp.where(pos_live, kmer_ids_pad, 0)
        counts = jnp.zeros(num_kmers, dtype).at[kid].add(
            jnp.where(pos_live, 1.0, 0.0)
        )
        safe_counts = jnp.where(counts > 0, counts, 1.0)
        means = jnp.zeros(num_kmers, dtype).at[kid].add(
            jnp.where(pos_live, pos_mean[1:] / safe_counts[kid], 0.0)
        )

        mean_by_pos = jnp.concatenate([jnp.zeros((1,), dtype), means[kid]])
        diff = sig[:, None] - mean_by_pos[n_safe]
        var_acc = jnp.zeros(N_max, dtype).at[flat_idx].add((w * diff * diff).reshape(-1))
        pos_var = jnp.where(norm > 0, var_acc / jnp.where(norm > 0, norm, 1.0), 0.0)
        stdevs = jnp.sqrt(
            jnp.zeros(num_kmers, dtype).at[kid].add(
                jnp.where(pos_live, pos_var[1:] / safe_counts[kid], 0.0)
            )
        )
        kmer_mask = (counts > 0) & (stdevs > 0)
        return (
            Zf, Zb, jnp.exp(newM1), jnp.exp(newE2), means, stdevs, kmer_mask
        )

    return fn


def banded_batch_train(
    batch: BandedBatch, log_m1, log_e2, kmer_ids_pad, num_kmers
) -> BandedTrainResult:
    """Per-read Baum-Welch estimates for every read in a padded batch.

    kmer_ids_pad: (R, N_max-1) int32, zero-padded per-position k-mer ids.
    """
    fn = jax.vmap(_train_single(batch, log_m1, log_e2, num_kmers))
    Zf, Zb, m1, e2, means, stdevs, kmer_mask = fn(
        batch.sig, batch.mu_pad, batch.c1_pad, batch.c2_pad, batch.bstart,
        batch.bw, batch.N, batch.T, kmer_ids_pad,
    )
    return BandedTrainResult(Zf, Zb, m1, e2, means, stdevs, kmer_mask)


def banded_batch_train_jit(batch: BandedBatch, log_m1, log_e2, kmer_ids_pad,
                           num_kmers) -> BandedTrainResult:
    """`banded_batch_train` as one jitted program with the transitions as
    traced scalars, so successive training batches reuse the compile."""
    dt = batch.sig.dtype
    return _train_jit(
        batch.sig, batch.mu_pad, batch.c1_pad, batch.c2_pad, batch.bstart,
        batch.T, batch.N, batch.bw, kmer_ids_pad,
        jnp.asarray(log_m1, dt), jnp.asarray(log_e2, dt),
        pad=batch.pad, B=batch.B, num_kmers=int(num_kmers),
    )


@functools.partial(jax.jit, static_argnames=("pad", "B", "num_kmers"))
def _train_jit(sig, mu_pad, c1_pad, c2_pad, bstart, T, N, bw, kmer_ids_pad,
               log_m1, log_e2, *, pad, B, num_kmers):
    batch = BandedBatch(sig, mu_pad, c1_pad, c2_pad, bstart, T, N, bw, pad, B)
    return banded_batch_train(batch, log_m1, log_e2, kmer_ids_pad, num_kmers)


def make_banded_batch_fn(m1: float, e2: float):
    """Jitted entry: BandedBatch -> BandedBatchResult. The NamedTuple's
    pad/B fields are compile-time constants, so they route through
    static_argnames rather than the pytree."""
    log_m1, log_e2 = math.log(m1), math.log(e2)

    @functools.partial(jax.jit, static_argnames=("pad", "B"))
    def run_arrays(sig, mu_pad, c1_pad, c2_pad, bstart, T, N, bw, pad, B):
        batch = BandedBatch(sig, mu_pad, c1_pad, c2_pad, bstart, T, N, bw, pad, B)
        return banded_batch_run(batch, log_m1, log_e2)

    def run(batch: BandedBatch) -> BandedBatchResult:
        return run_arrays(
            batch.sig, batch.mu_pad, batch.c1_pad, batch.c2_pad, batch.bstart,
            batch.T, batch.N, batch.bw, pad=batch.pad, B=batch.B,
        )

    return run


def check_z_batch(Zf: np.ndarray, Zb: np.ndarray, T: np.ndarray, B: int, dtype) -> np.ndarray:
    """Vector of per-read pass/fail for the forward/backward invariant."""
    eps = z_epsilon(dtype)
    cells = T.astype(np.float64) * B
    ok = np.isfinite(Zf) & np.isfinite(Zb)
    return ok & (np.abs(Zf - Zb) / cells <= eps)


def traceback_batch(
    result: BandedBatchResult,
    batch_bstart: np.ndarray,
    T: np.ndarray,
    N: np.ndarray,
    bw: np.ndarray,
    kmer_size: int,
):
    """Host-side traceback for each read in the batch.

    Uses the native C++ walker when built (dynamont_jax/_native), else a
    pure-Python walk. Returns list of segment lists [(state, basepos, start_t,
    median_prob)] in read order; entry is None for reads whose Z check failed
    upstream (caller filters).
    """
    from dynamont_jax.native import banded_traceback

    PM = np.asarray(result.PM)
    PE = np.asarray(result.PE)
    choices = np.asarray(result.choices)
    out = []
    for i in range(PM.shape[0]):
        out.append(
            banded_traceback(
                choices[i], PM[i], PE[i],
                np.asarray(batch_bstart[i]), int(T[i]), int(N[i]), int(bw[i]),
                kmer_size,
            )
        )
    return out
