"""NTC (resquiggle / error-correction) preprocessing: the two 2D pre-passes
that sparsify the 3D T x N x K lattice (ref: src/cpp/NTC.cpp:80-398).

* TN pass: full-lattice 2-state DP over signal x basecalled k-mer sequence —
  the same recurrence as the NT model (reused from ops/nt_full) with the
  ppTN transitions.
* TK pass: 2-state DP over signal x ALL k-mers, where the M state sums over
  the 4 predecessor k-mers. In the dense integer k-mer coding, predecessor
  access k' = k//A + j*A^(S-1) is a (A, K/A) reshape and successor access
  k' = (k%A^(S-1))*A + j a (K/A, A) reshape — no gathers.
* Per-column candidate selection: sort descending (stable, ties by index —
  ref: utils.cpp:163-177 columnArgsort), accumulate log-probability mass,
  keep until it exceeds log(0.95) (TN breaks on '>', TK on '>=' — ref:
  NTC.cpp:266-270, 337-341).

All outputs are static-shaped: per-column candidate index arrays padded to a
cap with a sentinel, plus per-column counts.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dynamont_jax.ops import nt_full

NEG_INF = -jnp.inf
SPARSE_THRESHOLD = math.log(0.95)  # ref: NTC.hpp:29


class PrePassResult(NamedTuple):
    cand: jax.Array    # (T, C) int32 selected indices, ascending, sentinel-padded
    count: jax.Array   # (T,) int32 number of valid candidates per column
    Zf: jax.Array
    Zb: jax.Array
    overflow: jax.Array  # bool: some column needed more than C candidates


def _select_columns(LP, cap: int, ge_break: bool, sentinel: int):
    """Reference column selection, vectorized over columns.

    LP: (T, C) combined posterior log-probs. Returns (cand (T,cap) ascending,
    count (T,), overflow bool). Selection: stable-descending order, include
    until the running logsumexp crosses the threshold (break AFTER adding the
    crossing element; '>' or '>=' per ge_break).
    """
    T, C = LP.shape
    # stable descending argsort = stable ascending argsort of -LP
    order = jnp.argsort(-LP, axis=1, stable=True)
    sorted_lp = jnp.take_along_axis(LP, order, axis=1)
    # running logsumexp along the sorted column
    run = jax.lax.associative_scan(jnp.logaddexp, sorted_lp, axis=1)
    crossed = run >= SPARSE_THRESHOLD if ge_break else run > SPARSE_THRESHOLD
    # include element i iff no element before it crossed
    prev_crossed = jnp.concatenate(
        [jnp.zeros((T, 1), bool), crossed[:, :-1]], axis=1
    )
    included = ~prev_crossed
    count = included.sum(axis=1).astype(jnp.int32)
    overflow = jnp.any(count > cap)
    # gather the first `cap` included indices (they are the first positions
    # of the sorted order), then sort ascending with sentinel padding
    eff = min(cap, C)
    take = order[:, :eff]
    if eff < cap:
        take = jnp.concatenate(
            [take, jnp.full((T, cap - eff), sentinel, take.dtype)], axis=1
        )
    in_cap = jnp.arange(cap)[None, :] < count[:, None]
    cand = jnp.where(in_cap, take, sentinel)
    cand = jnp.sort(cand, axis=1)
    return cand.astype(jnp.int32), jnp.minimum(count, cap), overflow


def pre_tn(scores, ppTNm: float, ppTNe: float, cap: int):
    """TN pre-pass (ref: NTC.cpp:229-280). scores: (T-1, N-1) emission matrix
    from nt_full.emission_scores. Returns PrePassResult with n-candidates."""
    forM, forE = nt_full.make_nt_forward(ppTNm, ppTNe)(scores)
    backM, backE = nt_full.make_nt_backward(ppTNm, ppTNe)(scores)
    Zf = forE[-1, -1]
    Zb = backE[0, 0]
    # combined LP = logPlus(M-posterior, E-posterior), normalized by Zf
    # (ref: NTC.cpp:251 uses Zf for TN)
    LP = jnp.logaddexp(forM + backM - Zf, forE + backE - Zf)
    N = LP.shape[1]
    cand, count, overflow = _select_columns(LP, cap, ge_break=False, sentinel=N)
    return PrePassResult(cand, count, Zf, Zb, overflow)


def _prec_sum(E_prev, alphabet_size: int):
    """X[k] = logsumexp_j E_prev[prec_j(k)]; prec_j(k) = k//A + j*(K//A)."""
    K = E_prev.shape[-1]
    step = K // alphabet_size
    g = E_prev.reshape(alphabet_size, step)
    m = jnp.max(g, axis=0)
    safe_m = jnp.where(jnp.isfinite(m), m, 0.0)
    x = jnp.log(jnp.sum(jnp.exp(g - safe_m), axis=0)) + safe_m
    x = jnp.where(jnp.isfinite(m), x, NEG_INF)
    return jnp.repeat(x, alphabet_size)


def _suc_sum(vals, alphabet_size: int):
    """Y[k] = logsumexp_j vals[suc_j(k)]; suc_j(k) = (k % (K//A))*A + j.
    vals already includes any per-successor additive terms."""
    K = vals.shape[-1]
    step = K // alphabet_size
    g = vals.reshape(step, alphabet_size)
    m = jnp.max(g, axis=1)
    safe_m = jnp.where(jnp.isfinite(m), m, 0.0)
    y = jnp.log(jnp.sum(jnp.exp(g - safe_m[:, None]), axis=1)) + safe_m
    y = jnp.where(jnp.isfinite(m), y, NEG_INF)
    return jnp.tile(y, alphabet_size)


def tk_forward(sig, means, c1, c2, ppTKm: float, ppTKe: float,
               alphabet_size: int):
    """ppForTK (ref: NTC.cpp:145-169). Returns (M, E) of shape (T, K)."""
    K = means.shape[0]
    dtype = sig.dtype

    def step(carry, sig_t):
        M_prev, E_prev = carry
        d = sig_t - means
        sc = c1 - c2 * d * d
        M_new = _prec_sum(E_prev, alphabet_size) + sc + ppTKm
        E_new = jnp.logaddexp(M_prev + sc, E_prev + sc + ppTKe)
        return (M_new, E_new), (M_new, E_new)

    M0 = jnp.full((K,), NEG_INF, dtype)
    E0 = jnp.zeros((K,), dtype)
    _, (Ms, Es) = jax.lax.scan(step, (M0, E0), sig)
    return (
        jnp.concatenate([M0[None], Ms], axis=0),
        jnp.concatenate([E0[None], Es], axis=0),
    )


def tk_backward(sig, means, c1, c2, ppTKm: float, ppTKe: float,
                alphabet_size: int):
    """ppBackTK (ref: NTC.cpp:189-217). Returns (M, E) of shape (T, K)."""
    K = means.shape[0]
    dtype = sig.dtype

    def step(carry, sig_t):
        M_next, E_next = carry
        d = sig_t - means
        sc = c1 - c2 * d * d
        M_new = E_next + sc
        ext = _suc_sum(M_next + sc + ppTKm, alphabet_size)
        E_new = jnp.logaddexp(ext, E_next + sc + ppTKe)
        return (M_new, E_new), (M_new, E_new)

    M_last = jnp.full((K,), NEG_INF, dtype)
    E_last = jnp.zeros((K,), dtype)
    _, (Ms, Es) = jax.lax.scan(step, (M_last, E_last), sig, reverse=True)
    return (
        jnp.concatenate([Ms, M_last[None]], axis=0),
        jnp.concatenate([Es, E_last[None]], axis=0),
    )


def pre_tk(sig, means, c1, c2, ppTKm: float, ppTKe: float,
           alphabet_size: int, cap: int):
    """TK pre-pass (ref: NTC.cpp:291-349). Returns PrePassResult with
    k-candidates; normalization uses Zb (ref: NTC.cpp:322)."""
    from dynamont_jax.utils.logmath import logsumexp

    forM, forE = tk_forward(sig, means, c1, c2, ppTKm, ppTKe, alphabet_size)
    backM, backE = tk_backward(sig, means, c1, c2, ppTKm, ppTKe, alphabet_size)
    Zf = logsumexp(forE[-1])
    Zb = logsumexp(backE[0])
    LP = jnp.logaddexp(forM + backM - Zb, forE + backE - Zb)
    K = LP.shape[1]
    cand, count, overflow = _select_columns(LP, cap, ge_break=True, sentinel=K)
    return PrePassResult(cand, count, Zf, Zb, overflow)
