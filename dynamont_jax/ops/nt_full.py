"""Full-lattice 2-state NT pair-HMM: forward/backward/posterior/Viterbi.

The model (ref: src/cpp/NT.cpp): latent states per (t, n) cell are
M (a new segment starts: consume one signal sample and one k-mer) and
E (extend the current segment: consume one signal sample, keep the k-mer).

    M[t,n] = E[t-1,n-1] + score(t-1, n-1) + log m1
    E[t,n] = logaddexp(M[t-1,n] + score(t-1, n-1),
                       E[t-1,n] + score(t-1, n-1) + log e2)

with score(t, n) = log N(sig[t]; model[kmerSeq[n]]). Everything is computed
as a `lax.scan` over t with vectorized rows over n — the t-loop is the
inherent wavefront, the n-row maps onto the VPU. Matrices are (T, N) with
T = len(sig)+1, N = n_kmers+1.

This module is the exact-parity implementation (float64 by default); the
production banded/Pallas kernels live in nt_banded*.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dynamont_jax.constants import EPSILON
from dynamont_jax.utils.logmath import log_normal_pdf

NEG_INF = -jnp.inf


class NTMatrices(NamedTuple):
    forM: jax.Array  # (T, N)
    forE: jax.Array
    backM: jax.Array
    backE: jax.Array
    Zf: jax.Array  # scalar
    Zb: jax.Array


def emission_scores(sig, kmer_ids, means, stdevs, dtype=jnp.float64):
    """SC[t, n] = log N(sig[t]; model[kmer_ids[n]]), shape (T-1, N-1)."""
    sig = jnp.asarray(sig, dtype)
    mu = jnp.asarray(means, dtype)[kmer_ids]
    sd = jnp.asarray(stdevs, dtype)[kmer_ids]
    return log_normal_pdf(sig[:, None], mu[None, :], sd[None, :])


def _row_init(N, dtype):
    return jnp.full((N,), NEG_INF, dtype=dtype)


def make_nt_forward(log_m1, log_e2):
    def step(carry, sc_row):
        M_prev, E_prev = carry
        neg = jnp.full((1,), NEG_INF, sc_row.dtype)
        # M[t, 1:] = E[t-1, 0:N-1] + sc + m1
        M_new = jnp.concatenate([neg, E_prev[:-1] + sc_row + log_m1])
        E_new = jnp.concatenate(
            [neg, jnp.logaddexp(M_prev[1:] + sc_row, E_prev[1:] + sc_row + log_e2)]
        )
        return (M_new, E_new), (M_new, E_new)

    def forward(scores):
        Tm1, Nm1 = scores.shape
        N = Nm1 + 1
        dtype = scores.dtype
        M0 = _row_init(N, dtype)
        E0 = _row_init(N, dtype).at[0].set(0.0)
        (_, _), (Ms, Es) = jax.lax.scan(step, (M0, E0), scores)
        M = jnp.concatenate([M0[None], Ms], axis=0)
        E = jnp.concatenate([E0[None], Es], axis=0)
        return M, E

    return forward


def make_nt_backward(log_m1, log_e2):
    def step(carry, sc_row):
        M_next, E_next = carry
        # ext[n] = M[t+1, n+1] + sc[t, n] + m1      for n < N-1
        ext = jnp.concatenate([M_next[1:] + sc_row + log_m1, jnp.full((1,), NEG_INF, sc_row.dtype)])
        # n >= 1 terms use sc[t, n-1]
        M_new = jnp.concatenate(
            [jnp.full((1,), NEG_INF, sc_row.dtype), E_next[1:] + sc_row]
        )
        ext = ext.at[1:].set(jnp.logaddexp(ext[1:], E_next[1:] + sc_row + log_e2))
        return (M_new, ext), (M_new, ext)

    def backward(scores):
        Tm1, Nm1 = scores.shape
        N = Nm1 + 1
        dtype = scores.dtype
        M_last = _row_init(N, dtype)
        E_last = _row_init(N, dtype).at[N - 1].set(0.0)
        (_, _), (Ms, Es) = jax.lax.scan(step, (M_last, E_last), scores, reverse=True)
        M = jnp.concatenate([Ms, M_last[None]], axis=0)
        E = jnp.concatenate([Es, E_last[None]], axis=0)
        return M, E

    return backward


def nt_forward_backward(scores, m1, e2) -> NTMatrices:
    """Run both passes; m1/e2 are *probabilities* (logs taken here)."""
    log_m1 = math.log(m1)
    log_e2 = math.log(e2)
    forM, forE = make_nt_forward(log_m1, log_e2)(scores)
    backM, backE = make_nt_backward(log_m1, log_e2)(scores)
    return NTMatrices(forM, forE, backM, backE, forE[-1, -1], backE[0, 0])


def check_z(Zf, Zb, n_cells) -> bool:
    """Forward/backward consistency invariant (ref: NT_main.cpp:146)."""
    Zf = float(Zf)
    Zb = float(Zb)
    if math.isinf(Zf) or math.isinf(Zb):
        return False
    return abs(Zf - Zb) / n_cells <= EPSILON


def posterior_matrices(mats: NTMatrices):
    """LPM/LPE = for + back - Z (ref: utils.cpp:506-513), Z = Zb as the
    reference passes backward Z into logP."""
    Z = mats.Zb
    LPM = mats.forM + mats.backM - Z
    LPE = mats.forE + mats.backE - Z
    return LPM, LPE


def nt_viterbi_choices(LPM, LPE):
    """Max-recurrence over posterior log-probs (ref: NT.cpp:100-131).

    Returns the per-cell traceback predicate bit
        choice[t, n] = (E[t,n] == M[t-1,n] + LPE[t,n])
    exactly as evaluated by the reference traceback (ref: NT.cpp:173),
    i.e. True selects the M-predecessor (ties included).
    """
    T, N = LPM.shape
    dtype = LPM.dtype

    def step(carry, lp_rows):
        M_prev, E_prev = carry
        lpm_row, lpe_row = lp_rows  # rows t, entries 1..N-1 used
        M_new = jnp.concatenate([jnp.full((1,), NEG_INF, dtype), E_prev[:-1] + lpm_row[1:]])
        m_arm = M_prev[1:] + lpe_row[1:]
        e_arm = E_prev[1:] + lpe_row[1:]
        E_new = jnp.concatenate([jnp.full((1,), NEG_INF, dtype), jnp.maximum(m_arm, e_arm)])
        choice = jnp.concatenate(
            [jnp.zeros((1,), bool), E_new[1:] == m_arm]
        )
        return (M_new, E_new), choice

    M0 = _row_init(N, dtype)
    E0 = _row_init(N, dtype).at[0].set(0.0)
    (_, _), choices = jax.lax.scan(step, (M0, E0), (LPM[1:], LPE[1:]))
    choice0 = jnp.zeros((1, N), bool)
    return jnp.concatenate([choice0, choices], axis=0)


def nt_traceback(choices: np.ndarray, LPM: np.ndarray, LPE: np.ndarray, kmer_size: int):
    """Host-side MAP walk (ref: NT.cpp:146-177).

    Returns a list of segments [(state, basepos, start_t, median_prob)] in
    read order. state is always 'M' for the NT model.
    """
    T, N = choices.shape
    t, n = T - 1, N - 1
    is_m = False
    seg_probs: list[float] = []
    segments: list[tuple[str, int, int, float]] = []
    while t and n:
        if is_m:
            seg_probs.append(math.exp(LPM[t, n]))
            segments.append(("M", n - 1 + kmer_size // 2, t - 1, float(np.median(seg_probs))))
            seg_probs.clear()
            t -= 1
            n -= 1
            is_m = False
        else:
            seg_probs.append(math.exp(LPE[t, n]))
            is_m = bool(choices[t, n])
            t -= 1
    segments.reverse()
    return segments


def per_t_border_logprob(LPM):
    """-p output: per-t logsumexp over the LPM row (ref: NT_main.cpp:227-238)."""
    from dynamont_jax.utils.logmath import logsumexp

    return logsumexp(LPM, axis=1)
