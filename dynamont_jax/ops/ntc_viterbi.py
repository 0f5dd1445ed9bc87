"""NTC MAP segmentation: max-DP over posteriors + 5-state traceback with
polish (MAP k-mer) output (ref: src/cpp/NTC.cpp:595-904).

The max-DP (getBorders) shares the sparse candidate layout and alignment
maps of the forward pass; the walk itself is host-side (short: <= T + N
steps) and replicates the reference's equality checks in their exact order,
including the I-state's two non-exclusive ifs where an E match overrides an
earlier I match (ref: NTC.cpp:884-893).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from dynamont_jax.ops.ntc_dp import A, E, I, NEG_INF, P, S, NTCPlan, _gather_cols, _gather_rows
from dynamont_jax.utils.kmer import int2kmer


def ntc_max_dp(plan: NTCPlan, logp, N: int):
    """Viterbi-style max recurrence over posterior log-probs
    (ref: NTC.cpp:595-653). logp: (T, 5, CN, CK). Returns APSEI same shape."""
    T, CN = plan.cand_n.shape
    CK = plan.ks.shape[1]
    dtype = logp.dtype
    alphabet_size = plan.col_prec.shape[2]

    init = jnp.full((5, CN, CK), NEG_INF, dtype)
    row0 = (plan.cand_n[0] == 0)[:, None] & plan.allowed[0]
    init = init.at[E].set(jnp.where(row0, 0.0, NEG_INF))

    def step(carry, xs):
        prev = carry
        (lp, cn, allowed, row_same, row_prev, col_same, col_prec) = xs

        ge_same = _gather_rows(prev, row_same)
        ge_prev = _gather_rows(prev, row_prev)

        a_acc = jnp.full((CN, CK), NEG_INF, dtype)
        p_acc = jnp.full((CN, CK), NEG_INF, dtype)
        for ai in range(alphabet_size):
            gp = _gather_cols(ge_prev, col_prec[:, ai])
            gs = _gather_cols(ge_same, col_prec[:, ai])
            a_acc = jnp.maximum(a_acc, jnp.maximum(gp[E], gp[I]))
            p_acc = jnp.maximum(
                p_acc, jnp.maximum(gs[S], jnp.maximum(gs[E], gs[I]))
            )
        a_new = a_acc + lp[A]
        p_new = p_acc + lp[P]

        gpk = _gather_cols(ge_prev, col_same)
        s_new = jnp.maximum(gpk[P], jnp.maximum(gpk[E], gpk[I])) + lp[S]
        gsk = _gather_cols(ge_same, col_same)
        e_new = (
            jnp.maximum(
                jnp.maximum(gsk[A], gsk[P]), jnp.maximum(gsk[S], gsk[E])
            )
            + lp[E]
        )

        n_pos = (cn >= 1)[:, None]
        a_new = jnp.where(allowed & n_pos, a_new, NEG_INF)
        p_new = jnp.where(allowed & n_pos, p_new, NEG_INF)
        s_new = jnp.where(allowed & n_pos, s_new, NEG_INF)
        e_new = jnp.where(allowed & n_pos, e_new, NEG_INF)

        i_rows = []
        i_prev_row = jnp.full((CK,), NEG_INF, dtype)
        for i_slot in range(CN):
            if i_slot == 0:
                chain = jnp.asarray(False)
                e_above = jnp.full((CK,), NEG_INF, dtype)
            else:
                chain = cn[i_slot - 1] == cn[i_slot] - 1
                e_above = e_new[i_slot - 1]
            term = jnp.maximum(e_above, i_prev_row) + lp[I][i_slot]
            i_row = jnp.where(
                chain & allowed[i_slot] & (cn[i_slot] >= 1), term, NEG_INF
            )
            i_rows.append(i_row)
            i_prev_row = i_row
        i_new = jnp.stack(i_rows, axis=0)

        out = jnp.stack([a_new, p_new, s_new, e_new, i_new], axis=0)
        return out, out

    xs = (
        logp[1:], plan.cand_n[1:], plan.allowed[1:],
        plan.row_same[1:], plan.row_prev[1:], plan.col_same[1:],
        plan.col_prec[1:],
    )
    _, outs = jax.lax.scan(step, init, xs)
    return jnp.concatenate([init[None], outs], axis=0)


class _SparseView:
    """Host-side (t, n, k) -> (state values) lookup over the slot layout;
    missing cells read as -inf, mirroring unordered_map defaults."""

    def __init__(self, plan: NTCPlan, dense: np.ndarray):
        self.cand_n = np.asarray(plan.cand_n)
        self.ks = np.asarray(plan.ks)
        self.allowed = np.asarray(plan.allowed)
        self.dense = dense  # (T, 5, CN, CK)
        self._maps = {}

    def _tmap(self, t):
        m = self._maps.get(t)
        if m is None:
            m = {}
            cn, ks, al = self.cand_n[t], self.ks[t], self.allowed[t]
            for i, n in enumerate(cn):
                for j, k in enumerate(ks):
                    if al[i, j]:
                        m[(int(n), int(k))] = (i, j)
            self._maps[t] = m
        return m

    def get(self, t, n, k, state):
        if t < 0 or t >= self.dense.shape[0]:
            return -math.inf
        ij = self._tmap(t).get((n, k))
        if ij is None:
            return -math.inf
        return float(self.dense[t, state, ij[0], ij[1]])


def _prec_kmers(k, alphabet_size, K):
    step = K // alphabet_size
    return [k // alphabet_size + j * step for j in range(alphabet_size)]


def ntc_traceback(plan: NTCPlan, apsei: np.ndarray, logp: np.ndarray,
                  T: int, N: int, K: int, model):
    """5-state walk (ref: NTC.cpp:691-904). Returns segments in read order:
    [(state 'M'|'P', basepos, start_t, median_prob, polish_kmer_str)]."""
    ap = _SparseView(plan, apsei)
    lp = _SparseView(plan, logp)
    alphabet_size = model.alphabet_size
    half = model.kmer_size // 2

    # final k: max over allowed k of APSEI[T-1, N-1, k][E], ties -> last
    # (ref '>=' update, NTC.cpp:656-664 iterates k ascending)
    best_v, best_k = -math.inf, None
    cn, ks, al = ap.cand_n[T - 1], ap.ks[T - 1], ap.allowed[T - 1]
    live = np.asarray(plan.live)[T - 1]
    for i, n in enumerate(cn):
        if n != N - 1:
            continue
        for j, k in enumerate(ks):
            if al[i, j] and live[j]:
                v = float(apsei[T - 1, E, i, j])
                if v >= best_v:
                    best_v, best_k = v, int(k)
    if best_k is None:
        return []

    # native C++ walker when available (identical comparisons over the same
    # float64 tensors; falls back to the Python walk on any inconsistency)
    from dynamont_jax import native as _native

    nat = _native.ntc_traceback_native(
        apsei, logp, np.asarray(plan.cand_n), np.asarray(plan.ks),
        np.asarray(plan.allowed), T, N, K, alphabet_size, model.kmer_size,
        best_k,
    )
    if nat is not None:
        return [
            ("M" if st == 0 else "P", basepos, start, med,
             int2kmer(pk, alphabet_size, model.kmer_size, model.rna))
            for st, basepos, start, med, pk in nat
        ]

    t, n, k = T - 1, N - 1, best_k
    state = E
    seg_probs: list[float] = []
    segments: list[tuple] = []

    def kmer_str(kk):
        return int2kmer(kk, alphabet_size, model.kmer_size, model.rna)

    def emit(front_state, basepos, start):
        probs = sorted(seg_probs)
        m = len(probs)
        med = probs[m // 2] if m % 2 == 1 else 0.5 * (probs[m // 2 - 1] + probs[m // 2])
        segments.append((front_state, basepos, start, med, kmer_str(k)))
        seg_probs.clear()

    guard = 0
    while t:
        guard += 1
        if guard > 2 * (T + N) + 10:
            raise RuntimeError("NTC traceback did not terminate")
        if state == E:
            if t == 1:
                emit("M", half, 0)
                break
            sc = ap.get(t, n, k, E)
            ls = lp.get(t, n, k, E)
            seg_probs.append(math.exp(ls))
            if sc == ap.get(t - 1, n, k, E) + ls:
                state = E
            elif sc == ap.get(t - 1, n, k, A) + ls:
                state = A
            elif sc == ap.get(t - 1, n, k, S) + ls:
                state = S
            elif sc == ap.get(t - 1, n, k, P) + ls:
                state = P
            else:
                raise RuntimeError(f"backtrace error in E at t={t} n={n} k={k}")
            t -= 1
        elif state == A:
            if t == 1 and n == 1:
                emit("M", half, 0)
                break
            sc = ap.get(t, n, k, A)
            ls = lp.get(t, n, k, A)
            seg_probs.append(math.exp(ls))
            matched = False
            for pre in _prec_kmers(k, alphabet_size, K):
                if sc == ap.get(t - 1, n - 1, pre, E) + ls:
                    emit("M", n - 1 + half, t - 1)
                    state = E
                elif sc == ap.get(t - 1, n - 1, pre, I) + ls:
                    emit("M", n - 1 + half, t - 1)
                    state = I
                else:
                    continue
                t -= 1
                n -= 1
                k = pre
                matched = True
                break
            if not matched:
                raise RuntimeError(f"backtrace error in A at t={t} n={n} k={k}")
        elif state == P:
            if t == 1:
                emit("P", half, 0)
                break
            sc = ap.get(t, n, k, P)
            ls = lp.get(t, n, k, P)
            seg_probs.append(math.exp(ls))
            matched = False
            for pre in _prec_kmers(k, alphabet_size, K):
                if sc == ap.get(t - 1, n, pre, E) + ls:
                    emit("P", n - 1 + half, t - 1)
                    state = E
                elif sc == ap.get(t - 1, n, pre, S) + ls:
                    emit("P", n - 1 + half, t - 1)
                    state = S
                elif sc == ap.get(t - 1, n, pre, I) + ls:
                    emit("P", n - 1 + half, t - 1)
                    state = I
                else:
                    continue
                t -= 1
                k = pre
                matched = True
                break
            if not matched:
                raise RuntimeError(f"backtrace error in P at t={t} n={n} k={k}")
        elif state == S:
            if t == 1 and n == 1:
                break
            sc = ap.get(t, n, k, S)
            ls = lp.get(t, n, k, S)
            seg_probs.append(math.exp(ls))
            if sc == ap.get(t - 1, n - 1, k, E) + ls:
                state = E
            elif sc == ap.get(t - 1, n - 1, k, P) + ls:
                state = P
            elif sc == ap.get(t - 1, n - 1, k, I) + ls:
                state = I
            t -= 1
            n -= 1
        elif state == I:
            if n == 1:
                break
            sc = ap.get(t, n, k, I)
            ls = lp.get(t, n, k, I)
            seg_probs.append(math.exp(ls))
            # two plain ifs in the reference: an E match overrides I
            if sc == ap.get(t, n - 1, k, I) + ls:
                state = I
            if sc == ap.get(t, n - 1, k, E) + ls:
                state = E
            n -= 1
    segments.reverse()
    return segments
