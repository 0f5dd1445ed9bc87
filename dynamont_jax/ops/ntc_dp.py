"""NTC 5-state sparse 3D DP (ref: src/cpp/NTC.cpp:417-578) on a static
candidate layout.

The reference stores the sparse T x N x K lattice in a hash map keyed by the
allowed cells (AND-combination of the TN and TK pre-passes plus the read's
own k-mer as baseline, ref: NTC.cpp:368-398). The static layout replaces the
hash map with per-column candidate slots:

    per t: CN n-slots   = sorted tnMap[t] candidates (sentinel-padded)
           CK k-slots   = sorted merge of tkMap[t] and the baselines
                          {kmerSeq[n-1] : n in tnMap[t]} (duplicates keep
                          their slot but are masked dead so reductions count
                          each (n, k) once)
    cell (t, i, j) allowed iff  k_j in tkMap[t]  or  k_j == kmerSeq[n_i - 1]

States per cell: A(lign) P(olish) S(equence) E(xtend) I(nsert)
(ref state legend: NTC.cpp:699-703). All cross-column predecessor lookups
are resolved by precomputed alignment maps (slot index of a value in the
previous/next column, -1 if absent); the I-state's in-column recurrence runs
as a short static loop over the CN n-slots.

Deviation from the reference: the reference pushes a baseline key for n=0
that reads kmerSeq[-1] (out-of-bounds, allocator garbage). We skip the n=0
baseline; everything else follows the reference cell-for-cell.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = -jnp.inf

# state indices (ref: NTC.cpp:699-703)
A, P, S, E, I = 0, 1, 2, 3, 4


class NTCPlan(NamedTuple):
    """Static-shaped sparse lattice description for one read."""

    cand_n: jax.Array   # (T, CN) int32 sorted n-candidates, sentinel N
    cnt_n: jax.Array    # (T,)
    ks: jax.Array       # (T, CK) int32 sorted merged k-slots, sentinel K
    live: jax.Array     # (T, CK) bool: first occurrence and not sentinel
    from_tk: jax.Array  # (T, CK) bool: value is in tkMap[t]
    allowed: jax.Array  # (T, CN, CK) bool cell mask
    # per-slot model/score data (bulk-gathered once):
    mu_k: jax.Array     # (T, CK) model mean of k_j
    c1_k: jax.Array
    c2_k: jax.Array
    kN: jax.Array       # (T, CN) kmerSeq[n_i - 1] (0 where invalid)
    mu_n: jax.Array     # (T, CN) model mean of kN
    c1_n: jax.Array
    c2_n: jax.Array
    kN2: jax.Array      # (T, CN) kmerSeq[n_i] (backward scores, 0 invalid)
    mu_n2: jax.Array
    c1_n2: jax.Array
    c2_n2: jax.Array
    # alignment maps (-1 = absent):
    row_same: jax.Array  # (T, CN) slot of n_i in cand_n[t-1]
    row_prev: jax.Array  # (T, CN) slot of n_i - 1 in cand_n[t-1]
    col_same: jax.Array  # (T, CK) slot of k_j in ks[t-1]
    col_prec: jax.Array  # (T, CK, A) slot of prec_a(k_j) in ks[t-1]
    # forward in-column chain: cand_n[t][i-1] == n_i - 1 handled in-step
    # backward maps (lookups in column t+1):
    brow_same: jax.Array  # (T, CN) slot of n_i in cand_n[t+1]
    brow_next: jax.Array  # (T, CN) slot of n_i + 1 in cand_n[t+1]
    bcol_same: jax.Array  # (T, CK) slot of k_j in ks[t+1]
    bcol_suc: jax.Array   # (T, CK, A) slot of suc_a(k_j) in ks[t+1]
    suc_vals: jax.Array   # (T, CK, A) int32 successor kmer values
    mu_suc: jax.Array     # (T, CK, A) model params of successors
    c1_suc: jax.Array
    c2_suc: jax.Array
    # precomputed Hamming tables (batched path only; the per-read exact
    # path computes distances in-scan). Counts, int8:
    #   hd1[i,j]  = HD(kN_i, k_j); hd2[i,j] = HD(kN2_i, k_j)
    #   hd1s[i,j] = sum_{p=0..S-2} [digit_{p+1}(kN_i)  != digit_p(k_j)]
    #   hd2s[i,j] = same with kN2 — so that HD(x, suc_a(k)) decomposes as
    #   hdXs[i,j] + [digit_0(x) != a] (successor = left-shift + append a)
    hd1: jax.Array | None = None   # (T, CN, CK) int8
    hd2: jax.Array | None = None
    hd1s: jax.Array | None = None
    hd2s: jax.Array | None = None
    d01: jax.Array | None = None   # (T, CN) int8 lowest digit of kN
    d02: jax.Array | None = None   # (T, CN) int8 lowest digit of kN2


def hamming2(a, b, alphabet_size: int, kmer_size: int):
    """-2 * HammingDistance over base digits (ref: NTC.hpp:51-76)."""
    acc = jnp.zeros(jnp.broadcast_shapes(a.shape, b.shape), jnp.int32)
    x, y = a, b
    for _ in range(kmer_size):
        acc = acc + ((x % alphabet_size) != (y % alphabet_size)).astype(jnp.int32)
        x = x // alphabet_size
        y = y // alphabet_size
    return (-2 * acc).astype(jnp.float32)


def build_plan(cand_n, cnt_n, cand_k0, cnt_k, kmer_seq, means, c1, c2,
               alphabet_size: int, kmer_size: int, dtype=jnp.float64) -> NTCPlan:
    """Merge pre-pass candidates into the static lattice description.

    cand_n (T, CN) sorted asc with sentinel N; cand_k0 (T, CK0) sorted asc
    with sentinel K; kmer_seq (N-1,) int32.
    """
    T, CN = cand_n.shape
    CK0 = cand_k0.shape[1]
    K = means.shape[0]
    N = kmer_seq.shape[0] + 1
    step = K // alphabet_size

    n_valid = jnp.arange(CN)[None, :] < cnt_n[:, None]
    n_safe = jnp.clip(cand_n, 0, N - 1)
    kN = jnp.where(n_valid & (cand_n >= 1), kmer_seq[jnp.clip(n_safe - 1, 0, N - 2)], 0)
    base_k = jnp.where(n_valid & (cand_n >= 1), kN, K)  # sentinel K when absent

    merged = jnp.concatenate([cand_k0, base_k], axis=1)  # (T, CK0+CN)
    ks = jnp.sort(merged, axis=1).astype(jnp.int32)
    first = jnp.concatenate(
        [jnp.ones((T, 1), bool), ks[:, 1:] != ks[:, :-1]], axis=1
    )
    live = first & (ks < K)
    k_valid0 = jnp.arange(CK0)[None, :] < cnt_k[:, None]
    ck0 = jnp.where(k_valid0, cand_k0, K)
    from_tk = (ks[:, :, None] == ck0[:, None, :]).any(-1)

    allowed = (
        live[:, None, :]
        & n_valid[:, :, None]
        & (
            from_tk[:, None, :]
            | ((ks[:, None, :] == kN[:, :, None]) & (cand_n >= 1)[:, :, None])
        )
    )

    ks_safe = jnp.clip(ks, 0, K - 1)
    means = jnp.asarray(means, dtype)
    c1 = jnp.asarray(c1, dtype)
    c2 = jnp.asarray(c2, dtype)
    kN2 = jnp.where(n_valid & (cand_n < N - 1), kmer_seq[jnp.clip(n_safe, 0, N - 2)], 0)

    suc_base = (ks_safe % step) * alphabet_size
    suc_vals = suc_base[:, :, None] + jnp.arange(alphabet_size)[None, None, :]

    prev_n = jnp.concatenate([jnp.full((1, CN), N, cand_n.dtype), cand_n[:-1]], 0)
    prev_ks = jnp.concatenate([jnp.full((1, ks.shape[1]), K, ks.dtype), ks[:-1]], 0)
    next_n = jnp.concatenate([cand_n[1:], jnp.full((1, CN), N, cand_n.dtype)], 0)
    next_ks = jnp.concatenate([ks[1:], jnp.full((1, ks.shape[1]), K, ks.dtype)], 0)

    prec_base = ks_safe // alphabet_size
    prec_vals = prec_base[:, :, None] + (
        jnp.arange(alphabet_size)[None, None, :] * step
    )

    def slot2(values, table):
        eq = values[:, :, None] == table[:, None, :]
        found = eq.any(-1)
        return jnp.where(found, jnp.argmax(eq, -1).astype(jnp.int32), -1)

    def slot3(values, table):
        eq = values[:, :, :, None] == table[:, None, None, :]
        found = eq.any(-1)
        return jnp.where(found, jnp.argmax(eq, -1).astype(jnp.int32), -1)

    return NTCPlan(
        cand_n=cand_n.astype(jnp.int32), cnt_n=cnt_n.astype(jnp.int32),
        ks=ks, live=live, from_tk=from_tk, allowed=allowed,
        mu_k=means[ks_safe], c1_k=c1[ks_safe], c2_k=c2[ks_safe],
        kN=kN.astype(jnp.int32), mu_n=means[kN], c1_n=c1[kN], c2_n=c2[kN],
        kN2=kN2.astype(jnp.int32), mu_n2=means[kN2], c1_n2=c1[kN2], c2_n2=c2[kN2],
        row_same=slot2(cand_n, prev_n), row_prev=slot2(cand_n - 1, prev_n),
        col_same=slot2(ks, prev_ks), col_prec=slot3(prec_vals, prev_ks),
        brow_same=slot2(cand_n, next_n), brow_next=slot2(cand_n + 1, next_n),
        bcol_same=slot2(ks, next_ks), bcol_suc=slot3(suc_vals, next_ks),
        suc_vals=suc_vals.astype(jnp.int32),
        mu_suc=means[suc_vals], c1_suc=c1[suc_vals], c2_suc=c2[suc_vals],
    )


def _gather_rows(x, row_idx):
    """x (5, CN, CK), row_idx (CN,) -> (5, CN, CK) with -inf where idx<0."""
    g = x[:, jnp.clip(row_idx, 0, x.shape[1] - 1), :]
    return jnp.where((row_idx >= 0)[None, :, None], g, NEG_INF)


def _gather_cols(x, col_idx):
    """x (5, CN, CK), col_idx (CK,) -> (5, CN, CK) with -inf where idx<0."""
    g = x[:, :, jnp.clip(col_idx, 0, x.shape[2] - 1)]
    return jnp.where((col_idx >= 0)[None, None, :], g, NEG_INF)


def ntc_forward(plan: NTCPlan, sig, trans_log: dict, N: int,
                alphabet_size: int, kmer_size: int):
    """logF (ref: NTC.cpp:417-480). Returns (T, 5, CN, CK) forward values."""
    T, CN = plan.cand_n.shape
    CK = plan.ks.shape[1]
    dtype = sig.dtype
    tl = trans_log

    # t = 0 init: E = 0 at rows with n == 0, allowed slots
    init = jnp.full((5, CN, CK), NEG_INF, dtype)
    row0 = (plan.cand_n[0] == 0)[:, None] & plan.allowed[0]
    init = init.at[E].set(jnp.where(row0, 0.0, NEG_INF))

    def step(carry, xs):
        prev = carry  # (5, CN, CK)
        (sig_t, cn, cnt, ks, allowed, mu_k, c1_k, c2_k, kN, mu_n, c1_n, c2_n,
         row_same, row_prev, col_same, col_prec) = xs

        # emission score (ref: NTC.hpp:87-99)
        d_n = sig_t - mu_n
        sc_n = c1_n - c2_n * d_n * d_n            # (CN,)
        d_k = sig_t - mu_k
        sc_k = c1_k - c2_k * d_k * d_k            # (CK,)
        hd = hamming2(kN[:, None], ks[None, :], alphabet_size, kmer_size)
        sc = sc_n[:, None] + sc_k[None, :] + hd.astype(dtype)  # (CN, CK)

        ge_same = _gather_rows(prev, row_same)     # rows at n_i
        ge_prev = _gather_rows(prev, row_prev)     # rows at n_i - 1

        # A: sum over prec kmers of (t-1, n-1, k') states E, I
        # P: sum over prec kmers of (t-1, n,   k') states S, E, I
        a_acc = jnp.full((CN, CK), NEG_INF, dtype)
        p_acc = jnp.full((CN, CK), NEG_INF, dtype)
        for ai in range(alphabet_size):
            gp = _gather_cols(ge_prev, col_prec[:, ai])
            gs = _gather_cols(ge_same, col_prec[:, ai])
            a_acc = jnp.logaddexp(
                a_acc,
                jnp.logaddexp(gp[E] + tl["a1"], gp[I] + tl["a2"]),
            )
            p_acc = jnp.logaddexp(
                p_acc,
                jnp.logaddexp(
                    gs[S] + tl["p1"],
                    jnp.logaddexp(gs[E] + tl["p2"], gs[I] + tl["p3"]),
                ),
            )
        a_new = a_acc + sc
        p_new = p_acc + sc

        gpk = _gather_cols(ge_prev, col_same)
        s_new = (
            jnp.logaddexp(
                gpk[P] + tl["s1"],
                jnp.logaddexp(gpk[E] + tl["s2"], gpk[I] + tl["s3"]),
            )
            + sc
        )
        gsk = _gather_cols(ge_same, col_same)
        e_new = (
            jnp.logaddexp(
                jnp.logaddexp(gsk[A], gsk[P] + tl["e2"]),
                jnp.logaddexp(gsk[S] + tl["e3"], gsk[E] + tl["e4"]),
            )
            + sc
        )

        # n > 0 required for every recurrence cell (t>0 rows with n=0 stay -inf)
        n_pos = (cn >= 1)[:, None]
        a_new = jnp.where(allowed & n_pos, a_new, NEG_INF)
        p_new = jnp.where(allowed & n_pos, p_new, NEG_INF)
        s_new = jnp.where(allowed & n_pos, s_new, NEG_INF)
        e_new = jnp.where(allowed & n_pos, e_new, NEG_INF)

        # I: in-column chain over n-slots (ref I terms: NTC.cpp:474-477)
        i_rows = []
        i_prev_row = jnp.full((CK,), NEG_INF, dtype)
        for i_slot in range(CN):
            if i_slot == 0:
                chain = jnp.asarray(False)
                e_above = jnp.full((CK,), NEG_INF, dtype)
            else:
                chain = cn[i_slot - 1] == cn[i_slot] - 1
                e_above = e_new[i_slot - 1]
            term = jnp.logaddexp(e_above + tl["i1"], i_prev_row + tl["i2"]) + sc[i_slot]
            i_row = jnp.where(
                chain & allowed[i_slot] & (cn[i_slot] >= 1), term, NEG_INF
            )
            i_rows.append(i_row)
            i_prev_row = i_row
        i_new = jnp.stack(i_rows, axis=0)

        out = jnp.stack([a_new, p_new, s_new, e_new, i_new], axis=0)
        return out, out

    xs = (
        sig, plan.cand_n[1:], plan.cnt_n[1:], plan.ks[1:], plan.allowed[1:],
        plan.mu_k[1:], plan.c1_k[1:], plan.c2_k[1:],
        plan.kN[1:], plan.mu_n[1:], plan.c1_n[1:], plan.c2_n[1:],
        plan.row_same[1:], plan.row_prev[1:], plan.col_same[1:],
        plan.col_prec[1:],
    )
    _, outs = jax.lax.scan(step, init, xs)
    return jnp.concatenate([init[None], outs], axis=0)


def ntc_backward(plan: NTCPlan, sig, trans_log: dict, N: int,
                 alphabet_size: int, kmer_size: int):
    """logB (ref: NTC.cpp:495-578). Returns (T, 5, CN, CK)."""
    T, CN = plan.cand_n.shape
    CK = plan.ks.shape[1]
    dtype = sig.dtype
    tl = trans_log

    # terminal column t = T-1: E = 0 at (N-1, any allowed k)
    last = jnp.full((5, CN, CK), NEG_INF, dtype)
    rowN = (plan.cand_n[T - 1] == N - 1)[:, None] & plan.allowed[T - 1]
    last = last.at[E].set(jnp.where(rowN, 0.0, NEG_INF))

    def step(carry, xs):
        nxt = carry  # column t+1 values (5, CN, CK)
        (sig_t, sig_tm1, cn, allowed, ks, mu_k, c1_k, c2_k, kN, mu_n, c1_n,
         c2_n, kN2, mu_n2, c1_n2, c2_n2, brow_same, brow_next, bcol_same,
         bcol_suc, suc_vals, mu_suc, c1_suc, c2_suc, t) = xs

        # scores with kmerN = kmerSeq[n-1] (sc1) and kmerSeq[n] (sc2), vs k_j
        d_n = sig_t - mu_n
        scn = c1_n - c2_n * d_n * d_n
        d_n2 = sig_t - mu_n2
        scn2 = c1_n2 - c2_n2 * d_n2 * d_n2
        d_k = sig_t - mu_k
        sck = c1_k - c2_k * d_k * d_k
        hd1 = hamming2(kN[:, None], ks[None, :], alphabet_size, kmer_size).astype(dtype)
        hd2 = hamming2(kN2[:, None], ks[None, :], alphabet_size, kmer_size).astype(dtype)
        sc1 = scn[:, None] + sck[None, :] + hd1    # score(sig[t], kN, k)
        sc2 = scn2[:, None] + sck[None, :] + hd2   # score(sig[t], kN2, k)

        gn_same = _gather_rows(nxt, brow_same)     # (t+1, n, .)
        gn_next = _gather_rows(nxt, brow_next)     # (t+1, n+1, .)

        gsk = _gather_cols(gn_same, bcol_same)     # (t+1, n, k)
        gnk = _gather_cols(gn_next, bcol_same)     # (t+1, n+1, k)

        # guards: sc1-family terms need n>0, sc2-family terms need n<N-1
        # (t < T-1 is implicit: the scan only computes rows below the top)
        n_pos = (cn >= 1)[:, None]
        n_lt = (cn < N - 1)[:, None]
        a_new = jnp.where(n_pos, gsk[E] + sc1, NEG_INF)
        p_new = jnp.logaddexp(
            jnp.where(n_pos, gsk[E] + tl["e2"] + sc1, NEG_INF),
            jnp.where(n_lt, gnk[S] + tl["s1"] + sc2, NEG_INF),
        )
        s_acc = jnp.where(n_pos, gsk[E] + tl["e3"] + sc1, NEG_INF)
        e_acc = jnp.where(n_pos, gsk[E] + tl["e4"] + sc1, NEG_INF)
        i_acc = jnp.full((CN, CK), NEG_INF, dtype)
        for ai in range(alphabet_size):
            d_s = sig_t - mu_suc[:, ai]
            scs = c1_suc[:, ai] - c2_suc[:, ai] * d_s * d_s
            hds1 = hamming2(kN[:, None], suc_vals[None, :, ai],
                            alphabet_size, kmer_size).astype(dtype)
            hds2 = hamming2(kN2[:, None], suc_vals[None, :, ai],
                            alphabet_size, kmer_size).astype(dtype)
            sc1s = scn[:, None] + scs[None, :] + hds1
            sc2s = scn2[:, None] + scs[None, :] + hds2
            gsp = _gather_cols(gn_same, bcol_suc[:, ai])
            gna = _gather_cols(gn_next, bcol_suc[:, ai])
            s_acc = jnp.logaddexp(
                s_acc, jnp.where(n_pos, gsp[P] + tl["p1"] + sc1s, NEG_INF)
            )
            e_acc = jnp.logaddexp(
                e_acc, jnp.where(n_pos, gsp[P] + tl["p2"] + sc1s, NEG_INF)
            )
            i_acc = jnp.logaddexp(
                i_acc, jnp.where(n_pos, gsp[P] + tl["p3"] + sc1s, NEG_INF)
            )
            e_acc = jnp.logaddexp(
                e_acc, jnp.where(n_lt, gna[A] + tl["a1"] + sc2s, NEG_INF)
            )
            i_acc = jnp.logaddexp(
                i_acc, jnp.where(n_lt, gna[A] + tl["a2"] + sc2s, NEG_INF)
            )
        s_new = s_acc
        e_new = jnp.logaddexp(
            e_acc, jnp.where(n_lt, gnk[S] + tl["s2"] + sc2, NEG_INF)
        )
        i_new = jnp.logaddexp(
            i_acc, jnp.where(n_lt, gnk[S] + tl["s3"] + sc2, NEG_INF)
        )

        # same-t I chain (ref: NTC.cpp:565-572): uses sig[t-1] and kmerSeq[n]
        d_km1 = sig_tm1 - mu_k
        sck_m1 = c1_k - c2_k * d_km1 * d_km1
        d_nm1 = sig_tm1 - mu_n2
        scn2_m1 = c1_n2 - c2_n2 * d_nm1 * d_nm1
        sc_i = scn2_m1[:, None] + sck_m1[None, :] + hd2  # score(sig[t-1], kN2, k)
        t_pos = t > 0
        i_full_rows = [None] * CN
        i_below = jnp.full((CK,), NEG_INF, dtype)  # I_full at row i+1
        e_rows = [None] * CN
        for i_slot in range(CN - 1, -1, -1):
            if i_slot == CN - 1:
                chain = jnp.asarray(False)
            else:
                chain = cn[i_slot + 1] == cn[i_slot] + 1
            ok = chain & t_pos & (cn[i_slot] < N - 1)
            i_row = jnp.logaddexp(
                i_new[i_slot],
                jnp.where(ok, i_below + tl["i2"] + sc_i[i_slot], NEG_INF),
            )
            e_row = jnp.logaddexp(
                e_new[i_slot],
                jnp.where(ok, i_below + tl["i1"] + sc_i[i_slot], NEG_INF),
            )
            i_full_rows[i_slot] = i_row
            e_rows[i_slot] = e_row
            i_below = i_row
        i_new = jnp.stack(i_full_rows, axis=0)
        e_new = jnp.stack(e_rows, axis=0)

        a_new = jnp.where(allowed, a_new, NEG_INF)
        p_new = jnp.where(allowed, p_new, NEG_INF)
        s_new = jnp.where(allowed, s_new, NEG_INF)
        e_new = jnp.where(allowed, e_new, NEG_INF)
        i_new = jnp.where(allowed, i_new, NEG_INF)
        out = jnp.stack([a_new, p_new, s_new, e_new, i_new], axis=0)
        return out, out

    T_len = plan.cand_n.shape[0]
    sig_prev = jnp.concatenate([sig[:1] * 0, sig[:-1]])  # sig[t-1]; t=0 unused
    xs = (
        sig, sig_prev, plan.cand_n[:-1], plan.allowed[:-1], plan.ks[:-1],
        plan.mu_k[:-1], plan.c1_k[:-1], plan.c2_k[:-1],
        plan.kN[:-1], plan.mu_n[:-1], plan.c1_n[:-1], plan.c2_n[:-1],
        plan.kN2[:-1], plan.mu_n2[:-1], plan.c1_n2[:-1], plan.c2_n2[:-1],
        plan.brow_same[:-1], plan.brow_next[:-1], plan.bcol_same[:-1],
        plan.bcol_suc[:-1], plan.suc_vals[:-1],
        plan.mu_suc[:-1], plan.c1_suc[:-1], plan.c2_suc[:-1],
        jnp.arange(T_len - 1, dtype=jnp.int32),
    )
    _, outs = jax.lax.scan(step, last, xs, reverse=True)
    return jnp.concatenate([outs, last[None]], axis=0)


def ntc_z(plan: NTCPlan, forward, backward, N: int):
    """Zf over E at (T-1, N-1, k), Zb over E at (0, 0, k)
    (ref: NTC_main.cpp:152-158). Dead/duplicate slots excluded."""
    from dynamont_jax.utils.logmath import logsumexp

    rowN = (plan.cand_n[-1][:, None] == N - 1) & plan.allowed[-1] & plan.live[-1][None, :]
    Zf = logsumexp(jnp.where(rowN, forward[-1, E], NEG_INF))
    row0 = (plan.cand_n[0][:, None] == 0) & plan.allowed[0] & plan.live[0][None, :]
    Zb = logsumexp(jnp.where(row0, backward[0, E], NEG_INF))
    return Zf, Zb
