"""NTC Baum-Welch updates: 14 transition parameters + k-mer emissions
(ref: src/cpp/NTC.cpp:923-1130).

All reductions are bulk-vectorized over the (T, CN, CK) candidate lattice —
the reference's per-allowed-cell loop becomes masked tensor logsumexps, with
successor lookups resolved through the plan's backward alignment maps.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from dynamont_jax.ops.ntc_dp import (
    A, E, I, NEG_INF, P, S, NTCPlan, _gather_cols, _gather_rows, hamming2,
)
from dynamont_jax.utils.kmer import int2kmer


def _lse_all(x):
    m = jnp.max(x)
    safe = jnp.where(jnp.isfinite(m), m, 0.0)
    out = jnp.log(jnp.sum(jnp.exp(x - safe))) + safe
    return jnp.where(jnp.isfinite(m), out, NEG_INF)


def train_transitions(plan: NTCPlan, sig, fwd, bwd, logp, trans_log, Zf, N,
                      alphabet_size: int, kmer_size: int) -> dict:
    """trainTransition (ref: NTC.cpp:923-1045). Returns probabilities."""
    T, CN = plan.cand_n.shape
    CK = plan.ks.shape[1]
    dtype = sig.dtype
    tl = trans_log

    def per_t(args):
        (f_t, b_next, sig_t, cn, allowed, ks, mu_k, c1_k, c2_k, kN, mu_n,
         c1_n, c2_n, kN2, mu_n2, c1_n2, c2_n2, brow_same, brow_next,
         bcol_same, bcol_suc, suc_vals, mu_suc, c1_suc, c2_suc) = args

        d_n = sig_t - mu_n
        scn = c1_n - c2_n * d_n * d_n
        d_n2 = sig_t - mu_n2
        scn2 = c1_n2 - c2_n2 * d_n2 * d_n2
        d_k = sig_t - mu_k
        sck = c1_k - c2_k * d_k * d_k
        hd1 = hamming2(kN[:, None], ks[None, :], alphabet_size, kmer_size).astype(dtype)
        hd2 = hamming2(kN2[:, None], ks[None, :], alphabet_size, kmer_size).astype(dtype)
        sc1 = scn[:, None] + sck[None, :] + hd1
        sc2 = scn2[:, None] + sck[None, :] + hd2

        gn_same = _gather_rows(b_next, brow_same)
        gn_next = _gather_rows(b_next, brow_next)
        gsk = _gather_cols(gn_same, bcol_same)
        gnk = _gather_cols(gn_next, bcol_same)

        n_pos = (cn >= 1)[:, None] & allowed
        n_lt = (cn < N - 1)[:, None] & allowed

        terms = {}
        terms["e2"] = jnp.where(n_pos, f_t[P] + tl["e2"] + sc1 + gsk[E], NEG_INF)
        terms["e3"] = jnp.where(n_pos, f_t[S] + tl["e3"] + sc1 + gsk[E], NEG_INF)
        terms["e4"] = jnp.where(n_pos, f_t[E] + tl["e4"] + sc1 + gsk[E], NEG_INF)
        terms["s1"] = jnp.where(n_lt, f_t[P] + tl["s1"] + sc2 + gnk[S], NEG_INF)
        terms["s2"] = jnp.where(n_lt, f_t[E] + tl["s2"] + sc2 + gnk[S], NEG_INF)
        terms["s3"] = jnp.where(n_lt, f_t[I] + tl["s3"] + sc2 + gnk[S], NEG_INF)

        p1 = p2 = p3 = a1 = a2 = jnp.full((CN, CK), NEG_INF, dtype)
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
            p1 = jnp.logaddexp(p1, jnp.where(n_pos, f_t[S] + tl["p1"] + sc1s + gsp[P], NEG_INF))
            p2 = jnp.logaddexp(p2, jnp.where(n_pos, f_t[E] + tl["p2"] + sc1s + gsp[P], NEG_INF))
            p3 = jnp.logaddexp(p3, jnp.where(n_pos, f_t[I] + tl["p3"] + sc1s + gsp[P], NEG_INF))
            a1 = jnp.logaddexp(a1, jnp.where(n_lt, f_t[E] + tl["a1"] + sc2s + gna[A], NEG_INF))
            a2 = jnp.logaddexp(a2, jnp.where(n_lt, f_t[I] + tl["a2"] + sc2s + gna[A], NEG_INF))
        terms["p1"], terms["p2"], terms["p3"] = p1, p2, p3
        terms["a1"], terms["a2"] = a1, a2
        return {k: _lse_all(v) for k, v in terms.items()}

    args = (
        fwd[:-1], bwd[1:], sig, plan.cand_n[:-1], plan.allowed[:-1],
        plan.ks[:-1], plan.mu_k[:-1], plan.c1_k[:-1], plan.c2_k[:-1],
        plan.kN[:-1], plan.mu_n[:-1], plan.c1_n[:-1], plan.c2_n[:-1],
        plan.kN2[:-1], plan.mu_n2[:-1], plan.c1_n2[:-1], plan.c2_n2[:-1],
        plan.brow_same[:-1], plan.brow_next[:-1], plan.bcol_same[:-1],
        plan.bcol_suc[:-1], plan.suc_vals[:-1], plan.mu_suc[:-1],
        plan.c1_suc[:-1], plan.c2_suc[:-1],
    )
    per_t_sums = jax.vmap(per_t)(args)  # dict of (T-1,)
    acc = {k: float(_lse_all(v)) for k, v in per_t_sums.items()}

    # i1/i2: within-column terms over t in [1, T-1] (ref: NTC.cpp:990-999)
    # pv = backAPSEI[t, n+1, k][I]; contiguity means slot i+1 holds n+1
    sig_tm1 = sig  # sig[t-1] for t = 1..T-1 aligns with sig[0..T-2]
    cn = plan.cand_n[1:]
    chain = jnp.concatenate(
        [cn[:, 1:] == cn[:, :-1] + 1, jnp.zeros((T - 1, 1), bool)], axis=1
    )
    d_k = sig_tm1[:, None] - plan.mu_k[1:]
    sck = plan.c1_k[1:] - plan.c2_k[1:] * d_k * d_k
    d_n2 = sig_tm1[:, None] - plan.mu_n2[1:]
    scn2 = plan.c1_n2[1:] - plan.c2_n2[1:] * d_n2 * d_n2
    hd2 = jax.vmap(
        lambda a, b: hamming2(a[:, None], b[None, :], alphabet_size, kmer_size)
    )(plan.kN2[1:], plan.ks[1:]).astype(sig.dtype)
    sc_i = scn2[:, :, None] + sck[:, None, :] + hd2  # (T-1, CN, CK)
    bI = bwd[1:, I]  # (T-1, CN, CK) column t
    bI_up = jnp.concatenate(
        [bI[:, 1:, :], jnp.full((T - 1, 1, CK), NEG_INF, sig.dtype)], axis=1
    )
    ok = (
        chain[:, :, None]
        & plan.allowed[1:]
        & (cn < N - 1)[:, :, None]
    )
    f_slice = fwd[1:]
    i1_terms = jnp.where(ok, f_slice[:, E] + tl["i1"] + sc_i + bI_up, NEG_INF)
    i2_terms = jnp.where(ok, f_slice[:, I] + tl["i2"] + sc_i + bI_up, NEG_INF)
    acc["i1"] = float(_lse_all(i1_terms))
    acc["i2"] = float(_lse_all(i2_terms))

    # normalization groups (ref: NTC.cpp:1003-1030)
    def lsum(vals):
        fin = [v for v in vals if not math.isinf(v)]
        if not fin:
            return -math.inf
        m = max(fin)
        return m + math.log(sum(math.exp(v - m) for v in vals if not math.isinf(v)))

    out = dict(acc)
    Ae_ = lsum([acc["a1"], acc["s2"], acc["e4"], acc["i1"], acc["p2"]])
    if not math.isinf(Ae_):
        for kk in ("a1", "s2", "e4", "i1", "p2"):
            out[kk] = acc[kk] - Ae_
    As_ = lsum([acc["e3"], acc["p1"]])
    if not math.isinf(As_):
        for kk in ("e3", "p1"):
            out[kk] = acc[kk] - As_
    Ap_ = lsum([acc["e2"], acc["s1"]])
    if not math.isinf(Ap_):
        for kk in ("e2", "s1"):
            out[kk] = acc[kk] - Ap_
    Ai_ = lsum([acc["a2"], acc["i2"], acc["p3"], acc["s3"]])
    if not math.isinf(Ai_):
        for kk in ("a2", "i2", "p3", "s3"):
            out[kk] = acc[kk] - Ai_
    result = {k: math.exp(v) for k, v in out.items()}
    result["e1"] = 1.0
    return result


TRAIN_THRESHOLD = 1e-7  # ref: NTC.cpp:1101


def train_emissions(plan: NTCPlan, sig, logp, model) -> dict:
    """trainEmission (ref: NTC.cpp:1059-1130)."""
    T = logp.shape[0]
    K = model.num_kmers
    dtype = sig.dtype
    # w over the 5 states, allowed cells with t >= 1
    lw = logp[:, A]
    for st in (P, S, E, I):
        lw = jnp.logaddexp(lw, logp[:, st])
    t_ok = (jnp.arange(T) >= 1)[:, None, None]
    w = jnp.where(plan.allowed & t_ok, jnp.exp(lw), 0.0)
    w = jnp.nan_to_num(w, nan=0.0, posinf=0.0)
    sig_pad = jnp.concatenate([jnp.zeros((1,), dtype), sig])  # sig[t-1] at row t
    wsig = w * sig_pad[:, None, None]

    ks_flat = jnp.broadcast_to(
        jnp.clip(plan.ks, 0, K - 1)[:, None, :], plan.allowed.shape
    )
    flat_k = ks_flat.reshape(-1)
    means_num = jnp.zeros(K, dtype).at[flat_k].add(wsig.reshape(-1))
    norm = jnp.zeros(K, dtype).at[flat_k].add(w.reshape(-1))
    means = jnp.where(norm != 0, means_num / jnp.where(norm != 0, norm, 1.0), 0.0)

    keep = norm >= TRAIN_THRESHOLD
    diff = sig_pad[:, None, None] - means[jnp.clip(plan.ks, 0, K - 1)][:, None, :]
    w2 = jnp.where(keep[jnp.clip(plan.ks, 0, K - 1)][:, None, :], w, 0.0)
    var_num = jnp.zeros(K, dtype).at[flat_k].add((w2 * diff * diff).reshape(-1))
    stdevs = jnp.where(
        norm != 0, jnp.sqrt(var_num / jnp.where(norm != 0, norm, 1.0)), 0.0
    )

    means = np.asarray(means)
    stdevs = np.asarray(stdevs)
    out = {}
    for k in range(K):
        if stdevs[k] != 0.0:
            kmer = int2kmer(k, model.alphabet_size, model.kmer_size, model.rna)
            out[kmer] = (float(means[k]), float(stdevs[k]))
    return out
