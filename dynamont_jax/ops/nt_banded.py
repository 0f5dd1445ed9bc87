"""Banded 2-state NT pair-HMM, band-relative layout (ref: src/cpp/NT_banded.cpp).

Same M/E recurrences as nt_full but restricted to a diagonal band of width
B = 2*bandwidth + 3 around the midpoint t*N/T. All rows are stored in
band-relative coordinates j = n - bstart[t] + 1; when the band start advances
between consecutive t, predecessor lookups shift by one column:

    forward, shift s = bstart[t] - bstart[t-1] in {0, 1}:
        M[t,j] = E[t-1, j-1+s] + sc_b[j] + log m1
        E[t,j] = logaddexp(M[t-1, j+s] + sc_b[j], E[t-1, j+s] + sc_b[j] + log e2)

with sc_b[j] = log N(sig[t-1]; model[kmerSeq[n-1]]), n = bstart[t] + j - 1.

Everything is a lax.scan over t; per-step band windows of k-mer emission
parameters are dynamic slices of padded per-position arrays (contiguous, no
gathers). This module is the exact-parity scan implementation; the batched
production Pallas kernel shares the same geometry (see nt_banded_pallas.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dynamont_jax.ops.geometry import BandGeometry

NEG_INF = -jnp.inf


class BandedInputs(NamedTuple):
    sig: jax.Array  # (T-1,)
    mu_pad: jax.Array  # (N-1 + 2*pad,) padded per-position emission means
    c1_pad: jax.Array
    c2_pad: jax.Array
    pad: int


def make_banded_inputs(signal, kmer_ids, means, stdevs, geom: BandGeometry, dtype=jnp.float64) -> BandedInputs:
    """Per-position (n) emission parameters, padded so band windows never
    index out of range. Position arrays are indexed by n-1 (the k-mer id
    position), i.e. entry i corresponds to kmerSeq[i]."""
    log2pi = 1.8378770664093453
    mu = jnp.asarray(means, dtype)[kmer_ids]
    sd = jnp.asarray(stdevs, dtype)[kmer_ids]
    c1 = -0.5 * log2pi - jnp.log(sd)
    c2 = 0.5 / (sd * sd)
    pad = geom.bandwidth + 3
    padv = lambda a: jnp.pad(a, (pad, pad))
    return BandedInputs(
        sig=jnp.asarray(signal, dtype),
        mu_pad=padv(mu),
        c1_pad=padv(c1),
        c2_pad=padv(c2),
        pad=pad,
    )


def _geom_arrays(geom: BandGeometry):
    bstart = jnp.asarray(geom.bstart)
    shift = jnp.asarray(geom.shift.astype(np.int32))
    n_start = jnp.asarray(geom.n_start)
    n_end = jnp.asarray(geom.n_end)
    return bstart, shift, n_start, n_end


def _window(arr, start, size):
    return jax.lax.dynamic_slice(arr, (start,), (size,))


def _scores(inputs: BandedInputs, sig_t, param_start, B):
    mu = _window(inputs.mu_pad, param_start, B)
    c1 = _window(inputs.c1_pad, param_start, B)
    c2 = _window(inputs.c2_pad, param_start, B)
    d = sig_t - mu
    return c1 - c2 * d * d


def nt_banded_forward(inputs: BandedInputs, geom: BandGeometry, log_m1, log_e2):
    B = geom.B
    dtype = inputs.sig.dtype
    bstart, shift, n_start, n_end = _geom_arrays(geom)
    j_iota = jnp.arange(B)

    def step(carry, xs):
        M_prev, E_prev = carry
        sig_t, bs, s, ns, ne = xs
        # sc_b[j] = score at kmer position n-1 = bs + j - 2
        sc_b = _scores(inputs, sig_t, bs - 2 + inputs.pad, B)
        neg1 = jnp.full((1,), NEG_INF, dtype)
        # E_prev[j-1+s], M_prev[j+s], E_prev[j+s]
        E_m = jnp.where(s == 1, E_prev, jnp.concatenate([neg1, E_prev[:-1]]))
        M_e = jnp.where(s == 1, jnp.concatenate([M_prev[1:], neg1]), M_prev)
        E_e = jnp.where(s == 1, jnp.concatenate([E_prev[1:], neg1]), E_prev)
        M_new = E_m + sc_b + log_m1
        E_new = jnp.logaddexp(M_e + sc_b, E_e + sc_b + log_e2)
        # valid j: n in [max(1, n_start), n_end)
        j_lo = jnp.maximum(ns, 1) - bs + 1
        j_hi = ne - bs + 1
        valid = (j_iota >= j_lo) & (j_iota < j_hi)
        M_new = jnp.where(valid, M_new, NEG_INF)
        E_new = jnp.where(valid, E_new, NEG_INF)
        return (M_new, E_new), (M_new, E_new)

    M0 = jnp.full((B,), NEG_INF, dtype)
    E0 = M0.at[geom.z_index].set(0.0)
    xs = (inputs.sig, bstart[1:], shift[1:], n_start[1:], n_end[1:])
    (_, _), (Ms, Es) = jax.lax.scan(step, (M0, E0), xs)
    M = jnp.concatenate([M0[None], Ms], axis=0)
    E = jnp.concatenate([E0[None], Es], axis=0)
    return M, E


def nt_banded_backward(inputs: BandedInputs, geom: BandGeometry, log_m1, log_e2):
    B = geom.B
    N = geom.N
    dtype = inputs.sig.dtype
    bstart, shift, n_start, n_end = _geom_arrays(geom)
    j_iota = jnp.arange(B)

    def step(carry, xs):
        M_next, E_next = carry
        sig_t, bs, s_next, ns, ne = xs  # row t quantities; s_next = shift[t+1]
        n = bs + j_iota - 1
        # sc_a[j] = score at kmer position n  (term M[t+1, n+1] + sc_a + m1)
        sc_a = _scores(inputs, sig_t, bs - 1 + inputs.pad, B)
        # sc_b[j] = score at kmer position n-1 (terms with E[t+1, n])
        sc_b = _scores(inputs, sig_t, bs - 2 + inputs.pad, B)
        neg1 = jnp.full((1,), NEG_INF, dtype)
        # E_next at band col j - s_next
        E_n = jnp.where(s_next == 1, jnp.concatenate([neg1, E_next[:-1]]), E_next)
        # M_next at band col j + 1 - s_next
        M_n = jnp.where(s_next == 1, M_next, jnp.concatenate([M_next[1:], neg1]))
        ext = jnp.where(n + 1 < N, M_n + sc_a + log_m1, NEG_INF)
        has_prev = n > 0
        M_new = jnp.where(has_prev, E_n + sc_b, NEG_INF)
        ext = jnp.where(
            has_prev, jnp.logaddexp(ext, E_n + sc_b + log_e2), ext
        )
        E_new = ext
        valid = (j_iota >= ns - bs + 1) & (j_iota < ne - bs + 1)
        M_new = jnp.where(valid, M_new, NEG_INF)
        E_new = jnp.where(valid, E_new, NEG_INF)
        return (M_new, E_new), (M_new, E_new)

    M_last = jnp.full((B,), NEG_INF, dtype)
    E_last = M_last.at[geom.z_index].set(0.0)
    # row t consumes sig[t], shift[t+1], bounds of row t
    xs = (inputs.sig, bstart[:-1], shift[1:], n_start[:-1], n_end[:-1])
    (_, _), (Ms, Es) = jax.lax.scan(step, (M_last, E_last), xs, reverse=True)
    M = jnp.concatenate([Ms, M_last[None]], axis=0)
    E = jnp.concatenate([Es, E_last[None]], axis=0)
    return M, E


class BandedMatrices(NamedTuple):
    forM: jax.Array
    forE: jax.Array
    backM: jax.Array
    backE: jax.Array
    Zf: jax.Array
    Zb: jax.Array


def nt_banded_forward_backward(inputs, geom, m1, e2) -> BandedMatrices:
    log_m1, log_e2 = math.log(m1), math.log(e2)
    forM, forE = nt_banded_forward(inputs, geom, log_m1, log_e2)
    backM, backE = nt_banded_backward(inputs, geom, log_m1, log_e2)
    zi = geom.z_index
    return BandedMatrices(forM, forE, backM, backE, forE[-1, zi], backE[0, zi])


def banded_posteriors(mats: BandedMatrices):
    Z = mats.Zb
    return mats.forM + mats.backM - Z, mats.forE + mats.backE - Z


def nt_banded_viterbi_choices(LPM, LPE, geom: BandGeometry):
    """Banded max-recurrence (ref: NT_banded.cpp:139-189); note the banded
    variant computes max(M_prev, E_prev) + LPE (max-then-add). Returns the
    traceback predicate choice[t,j] = (E[t,j] == M[t-1, j+s] + LPE[t,j])."""
    B = geom.B
    dtype = LPM.dtype
    bstart, shift, n_start, n_end = _geom_arrays(geom)
    j_iota = jnp.arange(B)

    def step(carry, xs):
        M_prev, E_prev = carry
        lpm, lpe, bs, s, ns, ne = xs
        neg1 = jnp.full((1,), NEG_INF, dtype)
        E_m = jnp.where(s == 1, E_prev, jnp.concatenate([neg1, E_prev[:-1]]))
        M_e = jnp.where(s == 1, jnp.concatenate([M_prev[1:], neg1]), M_prev)
        E_e = jnp.where(s == 1, jnp.concatenate([E_prev[1:], neg1]), E_prev)
        M_new = E_m + lpm
        E_new = jnp.maximum(M_e, E_e) + lpe
        j_lo = jnp.maximum(ns, 1) - bs + 1
        valid = (j_iota >= j_lo) & (j_iota < ne - bs + 1)
        M_new = jnp.where(valid, M_new, NEG_INF)
        E_new = jnp.where(valid, E_new, NEG_INF)
        choice = E_new == (M_e + lpe)
        return (M_new, E_new), choice

    M0 = jnp.full((B,), NEG_INF, dtype)
    E0 = M0.at[geom.z_index].set(0.0)
    xs = (LPM[1:], LPE[1:], bstart[1:], shift[1:], n_start[1:], n_end[1:])
    (_, _), choices = jax.lax.scan(step, (M0, E0), xs)
    return jnp.concatenate([jnp.zeros((1, B), bool), choices], axis=0)


def nt_banded_traceback(choices, LPM, LPE, geom: BandGeometry, kmer_size: int):
    """Host-side MAP walk in band coordinates (ref: NT_banded.cpp:204-250)."""
    T, N, bw = geom.T, geom.N, geom.bandwidth
    bstart, shift = geom.bstart, geom.shift
    t, n = T - 1, N - 1
    j = bw + 1
    is_m = False
    seg_probs: list[float] = []
    segments: list[tuple[str, int, int, float]] = []
    while t and n:
        s = int(shift[t])  # band shift between t-1 and t
        if is_m:
            seg_probs.append(math.exp(LPM[t, j]))
            segments.append(("M", n - 1 + kmer_size // 2, t - 1, float(np.median(seg_probs))))
            seg_probs.clear()
            t -= 1
            n -= 1
            j = j - 1 + s
            is_m = False
        else:
            seg_probs.append(math.exp(LPE[t, j]))
            is_m = bool(choices[t, j])
            t -= 1
            j = j + s
    segments.reverse()
    return segments


def banded_per_t_logprob(LPM):
    from dynamont_jax.utils.logmath import logsumexp

    return logsumexp(LPM, axis=1)


def _band_score_matrix(inputs: BandedInputs, geom: BandGeometry, offset: int):
    """(T-1, B) emission scores; row t uses sig[t] and param window starting
    at bstart[t] + offset (offset -2 for kmer position n-1, -1 for n)."""
    B = geom.B
    starts = jnp.asarray(geom.bstart[: geom.T - 1]) + offset + inputs.pad

    def row(sig_t, st):
        return _scores(inputs, sig_t, st, B)

    return jax.vmap(row)(inputs.sig, starts)


def _roll_left(rows, fill=NEG_INF):
    return jnp.concatenate([rows[:, 1:], jnp.full((rows.shape[0], 1), fill, rows.dtype)], axis=1)


def _roll_right(rows, fill=NEG_INF):
    return jnp.concatenate([jnp.full((rows.shape[0], 1), fill, rows.dtype), rows[:, :-1]], axis=1)


def banded_train_transitions(mats: BandedMatrices, inputs: BandedInputs, geom: BandGeometry, trans: dict) -> dict:
    """Baum-Welch transition update over the band (ref: NT_banded.cpp:303-360)."""
    from dynamont_jax.utils.logmath import logsumexp

    log_m1, log_e2 = math.log(trans["m1"]), math.log(trans["e2"])
    B = geom.B
    n = jnp.asarray(geom.bstart[: geom.T - 1])[:, None] + jnp.arange(B)[None, :] - 1
    # shift between t and t+1 — EXCEPT the reference initializes its shift
    # tracker from bounds[0] instead of bounds[T-1] (ref: NT_banded.cpp:309),
    # so at t = T-2 the lookup shifts iff bstart[T-2] != bstart[0]. Replicated
    # verbatim for training parity.
    s_arr = geom.shift[1:].astype(np.int32).copy()
    if geom.T >= 2:
        s_arr[-1] = np.int32(geom.bstart[geom.T - 2] != geom.bstart[0])
    s_next = jnp.asarray(s_arr)[:, None]

    sc_a = _band_score_matrix(inputs, geom, -1)  # kmer position n
    sc_b = _band_score_matrix(inputs, geom, -2)  # kmer position n-1

    backM_next = mats.backM[1:]
    backE_next = mats.backE[1:]
    # backM[t+1] at band col j+1-s ; backE[t+1] at band col j-s
    backM_sh = jnp.where(s_next == 1, backM_next, _roll_left(backM_next))
    backE_sh = jnp.where(s_next == 1, _roll_right(backE_next), backE_next)

    forE = mats.forE[:-1]
    m1_terms = jnp.where(n + 1 < geom.N, forE + log_m1 + sc_a + backM_sh, NEG_INF)
    e2_terms = jnp.where(n > 0, forE + log_e2 + sc_b + backE_sh, NEG_INF)
    newM1 = logsumexp(m1_terms)
    newE2 = logsumexp(e2_terms)
    Ae = jnp.logaddexp(newE2, newM1)
    newM1 = jnp.where(jnp.isfinite(Ae), newM1 - Ae, newM1)
    newE2 = jnp.where(jnp.isfinite(Ae), newE2 - Ae, newE2)
    return {"m1": float(jnp.exp(newM1)), "e1": 1.0, "e2": float(jnp.exp(newE2))}


def banded_train_emissions(signal, kmer_ids, LPM, LPE, geom: BandGeometry, num_kmers: int):
    """Baum-Welch emission update over the band (ref: NT_banded.cpp:374-451).

    Posterior weights w = exp(LPM) + exp(LPE) accumulate per sequence
    position n, then per-k-mer means/stdevs average the per-position values.
    """
    T, N, B = geom.T, geom.N, geom.B
    dtype = LPM.dtype
    w = jnp.exp(LPM[1:]) + jnp.exp(LPE[1:])  # rows t = 1..T-1
    n_idx = jnp.asarray(geom.bstart[1:])[:, None] + jnp.arange(B)[None, :] - 1
    valid = (n_idx >= 0) & (n_idx < N)
    w = jnp.where(valid, w, 0.0)
    n_safe = jnp.clip(n_idx, 0, N - 1)
    sig = jnp.asarray(signal, dtype)

    flat_idx = n_safe.reshape(-1)
    kmers = jnp.zeros(N, dtype).at[flat_idx].add((w * sig[:, None]).reshape(-1))
    norm = jnp.zeros(N, dtype).at[flat_idx].add(w.reshape(-1))
    pos_mean = kmers / norm  # unconditional division like the reference

    kmer_ids = jnp.asarray(kmer_ids)
    counts = jnp.zeros(num_kmers, dtype).at[kmer_ids].add(1.0)
    safe_counts = jnp.where(counts > 0, counts, 1.0)
    means = jnp.zeros(num_kmers, dtype).at[kmer_ids].add(
        pos_mean[1:] / safe_counts[kmer_ids]
    )

    # second pass: posterior-weighted variance around the k-mer mean
    mean_by_pos = jnp.concatenate([jnp.zeros((1,), dtype), means[kmer_ids]])  # index by n
    diff = sig[:, None] - mean_by_pos[n_safe]
    var_acc = jnp.zeros(N, dtype).at[flat_idx].add((w * diff * diff).reshape(-1))
    pos_var = var_acc / norm
    stdevs = jnp.sqrt(
        jnp.zeros(num_kmers, dtype).at[kmer_ids].add(pos_var[1:] / safe_counts[kmer_ids])
    )
    return np.asarray(means), np.asarray(stdevs)
