"""Batched, bucketed NTC (resquiggle) pipeline as XLA scans.

The per-read NTC path (ops/ntc_pre, ops/ntc_dp) is exact fp64 and re-traces
per (T, N, cap) shape; this module runs a whole padded bucket of reads per
compiled program in fp32 (dtype-parametric), mirroring the banded "basic"
mode design (ops/nt_banded_batch / nt_banded_device):

* one static shape per bucket: (R, T_pad, N2, K, CN, CK0) — reads are
  padded with per-read true (T, N) masks, so XLA compiles a handful of
  programs for an entire dataset;
* all big tensors are scan-major (T, R, ...) and live only on device;
* memory is streamed, never held twice: each 2D pre-pass stores ONE
  direction and fuses the posterior combination + per-column candidate
  selection into the opposite-direction scan (ref: NTC.cpp:229-349 does
  forward+backward+columnArgsort per pass); the 3D DP stores the backward
  lattice once, then a second forward scan emits posteriors + Viterbi
  choice bits on the fly (fwd values are recomputed instead of stored);
* the candidate selection (keep top cells per column covering 95%
  posterior mass, ref: NTC.hpp:29, NTC.cpp:260-270,328-341) becomes a
  per-column top-k + running-logsumexp crossing test with a static cap;
  reads whose columns overflow the cap are flagged and re-run by the
  engine (bigger caps / exact per-read path);
* the sequential 5-state traceback runs on device (ops/ntc_walk) over the
  stored choice bits, so only per-segment summaries cross the host link.

Reference: the sparse 3D DP semantics follow src/cpp/NTC.cpp:417-578 via
the candidate-slot layout documented in ops/ntc_dp.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dynamont_jax.ops.ntc_dp import NTCPlan
from dynamont_jax.ops.ntc_pre import SPARSE_THRESHOLD
from dynamont_jax.utils.logmath import logsumexp

NEG_INF = -jnp.inf

# state indices (ref: NTC.cpp:699-703)
A_ST, P_ST, S_ST, E_ST, I_ST = 0, 1, 2, 3, 4


# ---------------------------------------------------------------------------
# per-column candidate selection (fused into the pre-pass scans)
# ---------------------------------------------------------------------------

def _topk_maxmask(U, cap: int):
    """Exact top-cap by iterative max-extraction. Matches lax.top_k
    (descending, ties -> lower index first: argmax picks the first
    occurrence and masking one index at a time preserves stable tie
    order). XLA fuses the `cap` passes into one sweep over U, skipping
    top_k's full per-column sort network. Exhausted columns repeat index 0 with
    -inf values; select_topk never includes entries past the 95%-mass
    crossing, which always precedes the -inf tail (run hits tot >= 0.95*tot
    at the last finite value), so the duplicates are unreachable
    downstream. The one divergence from top_k: an all--inf LIVE column
    yields cand [0]*cap instead of [0..cap-1] — but such a column sets
    overflow=True, which retires the whole read to the fallback ladder
    before any candidate is consumed."""
    lane = jax.lax.broadcasted_iota(jnp.int32, U.shape, U.ndim - 1)
    u = U
    vals, idxs = [], []
    for _ in range(cap):
        i = jnp.argmax(u, axis=-1).astype(jnp.int32)
        vals.append(jnp.max(u, axis=-1))
        idxs.append(i)
        u = jnp.where(lane == i[..., None], NEG_INF, u)
    return jnp.stack(vals, -1), jnp.stack(idxs, -1)


def select_topk(U, cap: int, ge_break: bool, col_live, sentinel: int):
    """Reference column selection on unnormalized posteriors.

    U: (R, W) combined log-probs f+b (unnormalized). The 95%-mass crossing
    (ref: NTC.cpp:266-270 '>' for TN, :337-341 '>=' for TK) is tested
    against the COLUMN's own mass rather than the global Z the reference
    divides by: they are equal by the forward-backward identity, but the
    global Z drifts from the per-column sums by ~0.5 nats in fp32 over
    ~16k scan steps, which would fail the crossing (and overflow the cap)
    on nearly every column. Returns (cand (R, cap) int32 selection-ordered
    (descending value) with the valid entries as a prefix and `sentinel`
    elsewhere, count, overflow).
    """
    W = U.shape[-1]
    if cap <= 16:
        vals, idx = _topk_maxmask(U, cap)
    elif W >= 32768 and cap * 128 <= W and W % 128 == 0:
        # big-K (native 9-mer, W = 4^9): exact two-stage top-cap — block
        # maxima, top-cap BLOCKS, then an exact top_k over the <=cap*128
        # gathered lanes. Every global top-cap element lives in a
        # selected block (a block holding one has max >= the cap-th
        # value; more than cap such blocks would mean more than cap such
        # elements). ~10x cheaper than a full-width top_k per scan step.
        # Tie caveat: equal values in different blocks merge in
        # block-max order rather than global-index order — the crossing
        # COUNT is unchanged (equal exp terms commute in the cumsum);
        # only which of the exactly-tied candidates is kept can differ,
        # measure-zero for continuous posteriors.
        Rr = U.shape[0]
        B = W // 128
        Ub = U.reshape(Rr, B, 128)
        bm = jnp.max(Ub, axis=2)
        _, bidx = jax.lax.top_k(bm, cap)                     # (R, cap)
        gath = jnp.take_along_axis(Ub, bidx[:, :, None], axis=1)
        vals, li = jax.lax.top_k(gath.reshape(Rr, cap * 128), cap)
        blk = jnp.take_along_axis(bidx, li // 128, axis=1)
        idx = blk * 128 + (li % 128)
    else:
        vals, idx = jax.lax.top_k(U, cap)  # desc, ties -> lower idx first
    # crossing test in exp space relative to the column max: one exp +
    # cumsum instead of an associative logaddexp scan (7 levels x
    # exp/log per element) + a separate logsumexp; exactly the same
    # comparison up to fp rounding of exp()
    m = vals[:, :1]
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    tot = jnp.sum(jnp.exp(U - m_safe), axis=1, keepdims=True)
    return crossing_from_topk(vals, idx, tot, ge_break, col_live, sentinel)


def crossing_from_topk(vals, idx, tot, ge_break: bool, col_live, sentinel):
    """select_topk's 95%-mass crossing given an already-extracted
    descending top-cap (vals, idx) and the column's exp-mass `tot`
    relative to vals[:, :1]."""
    m = vals[:, :1]
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    run = jnp.cumsum(jnp.exp(vals - m_safe), axis=1)
    thresh = math.exp(SPARSE_THRESHOLD) * tot
    dead = ~jnp.isfinite(m)
    crossed = (run >= thresh if ge_break else run > thresh) & ~dead
    prev = jnp.concatenate(
        [jnp.zeros_like(crossed[:, :1]), crossed[:, :-1]], axis=1
    )
    included = (~prev) & col_live[:, None]
    count = included.sum(axis=1).astype(jnp.int32)
    overflow = col_live & (~crossed[:, -1])
    cand = jnp.where(included, idx, sentinel)
    return cand.astype(jnp.int32), count, overflow


# ---------------------------------------------------------------------------
# TN pre-pass (full T x N 2-state DP, ref: NTC.cpp:80-132,229-280)
# ---------------------------------------------------------------------------

class PreBatchResult(NamedTuple):
    cand: jax.Array      # (T, R, C) int32, ascending per column, sentinel-pad
    cnt: jax.Array       # (T, R) int32
    Zf: jax.Array        # (R,)
    Zb: jax.Array        # (R,)
    overflow: jax.Array  # (R,) bool
    # optional kmer_seq values at cand-1 / cand (same order as cand), so
    # build_plan_batch can skip its two (T, R, CN) take gathers
    kn1: jax.Array | None = None   # (T, R, C) int32
    kn2: jax.Array | None = None   # (T, R, C) int32


LOG_2PI = 1.8378770664093453


def _tn_scores(sig_t, mu_n, sinv_n, l2s_n, n_live):
    """(R, N2-1) emission row; padded n positions are -inf. Same op order
    as utils.logmath.log_normal_pdf so the fp64 batched path is
    bit-identical to the per-read pre-pass (ops/ntc_pre.pre_tn)."""
    d = (sig_t[:, None] - mu_n) * sinv_n
    return jnp.where(n_live, -0.5 * (LOG_2PI + l2s_n + d * d), NEG_INF)


def pre_tn_batch(sig, kmer_ids, N_r, T_r, means, stdevs, log_m1, log_e2,
                 cap: int, dtype):
    """Batched TN pre-pass. sig (R, T_pad-1); kmer_ids (R, N2-1) 0-padded;
    returns PreBatchResult with n-candidates per (t, read) column.

    Stores only the forward lattice; the backward scan re-combines with it
    and selects candidates on the fly (normalization by Zf as in the
    reference, ref: NTC.cpp:251).
    """
    R, Tm1 = sig.shape
    T_pad = Tm1 + 1
    N2 = kmer_ids.shape[1] + 1
    sig = sig.astype(dtype)
    mu_n = jnp.asarray(means, dtype)[kmer_ids]
    sd = jnp.asarray(stdevs, dtype)
    sinv_n = (1.0 / sd)[kmer_ids]
    l2s_n = (2.0 * jnp.log(sd))[kmer_ids]
    n_live = jnp.arange(N2 - 1)[None, :] < (N_r - 1)[:, None]
    neg1 = jnp.full((R, 1), NEG_INF, dtype)

    # ---- forward scan, storing (T, R, N2) M/E --------------------------
    # covers t = 0..T_pad-1 in ONE scan (t=0 emits the init column) so the
    # multi-GB output is built in place — no [1:] slices / init concats,
    # which would each copy the whole lattice
    M0 = jnp.full((R, N2), NEG_INF, dtype)
    E0 = M0.at[:, 0].set(0.0)

    def fstep(carry, xs):
        M_prev, E_prev = carry
        sig_t, t = xs
        sc = _tn_scores(sig_t, mu_n, sinv_n, l2s_n, n_live)
        M_new = jnp.concatenate([neg1, E_prev[:, :-1] + sc + log_m1], axis=1)
        E_new = jnp.concatenate(
            [neg1, jnp.logaddexp(M_prev[:, 1:] + sc, E_prev[:, 1:] + sc + log_e2)],
            axis=1,
        )
        first = t == 0
        M_new = jnp.where(first, M0, M_new)
        E_new = jnp.where(first, E0, E_new)
        # store flat (R*N2,): one contiguous row per step
        return (M_new, E_new), (M_new.reshape(-1), E_new.reshape(-1))

    sig_f = jnp.concatenate([jnp.zeros((R, 1), dtype), sig], axis=1)  # sig[t-1]
    _, (fM, fE) = jax.lax.scan(
        fstep, (M0, E0), (sig_f.T, jnp.arange(T_pad, dtype=jnp.int32))
    )

    r_iota = jnp.arange(R)
    Zf = fE[T_r - 1, r_iota * N2 + N_r - 1]

    # ---- backward scan with fused selection ----------------------------
    n_iota = jnp.arange(N2)[None, :]

    def bstep(carry, xs):
        M_next, E_next = carry
        sig_t, fM_t, fE_t, t = xs
        fM_t = fM_t.reshape(R, N2)
        fE_t = fE_t.reshape(R, N2)
        sc = _tn_scores(sig_t, mu_n, sinv_n, l2s_n, n_live)
        ext = jnp.concatenate([M_next[:, 1:] + sc + log_m1, neg1], axis=1)
        M_new = jnp.concatenate([neg1, E_next[:, 1:] + sc], axis=1)
        ext = ext.at[:, 1:].set(
            jnp.logaddexp(ext[:, 1:], E_next[:, 1:] + sc + log_e2)
        )
        is_term = (t == T_r - 1)[:, None]
        dead = (t > T_r - 1)[:, None]
        term_E = jnp.where(n_iota == (N_r - 1)[:, None], 0.0, NEG_INF).astype(dtype)
        M_out = jnp.where(is_term | dead, NEG_INF, M_new)
        E_out = jnp.where(is_term, term_E, jnp.where(dead, NEG_INF, ext))
        U = jnp.logaddexp(fM_t + M_out, fE_t + E_out)
        cand, cnt, ovf = select_topk(
            U, cap, ge_break=False, col_live=t <= T_r - 1, sentinel=N2,
        )
        return (M_out, E_out), (cand, cnt, ovf)

    sig_b = jnp.concatenate([sig, jnp.zeros((R, 1), dtype)], axis=1)  # sc row t
    xs = (sig_b.T, fM, fE, jnp.arange(T_pad, dtype=jnp.int32))
    (_, E_back0), (cand, cnt, ovf) = jax.lax.scan(
        bstep, (M0, M0), xs, reverse=True
    )
    Zb = E_back0[:, 0]
    # ascending candidate order is required downstream: the I-state chain
    # walks n-slots in increasing n (ref: NTC.cpp:474-477)
    cand = jnp.sort(cand, axis=2)
    return PreBatchResult(cand, cnt, Zf, Zb, ovf.any(axis=0))


# ---------------------------------------------------------------------------
# TK pre-pass (dense T x K 2-state DP, ref: NTC.cpp:145-217,291-349)
# ---------------------------------------------------------------------------

def _stretch4(x, K: int):
    """(R, step) -> (R, K) with out[:, k] = x[:, k//4], as block einsums
    against a constant (128, 512) one-hot. On an H100 the one-hot forms
    of _stretch4/_pick4/_sum4 and _gr/_gc ran a 48-read 16k-sample NTC
    pool in 14.06 s against 14.43 s for repeat/strided slices and
    take_along_axis (PERF.md), so they stay."""
    R, step = x.shape
    P = (jnp.arange(128)[:, None]
         == jnp.arange(512)[None, :] // 4).astype(x.dtype)
    out = jnp.einsum("rbi,iu->rbu", x.reshape(R, step // 128, 128), P,
                     precision=jax.lax.Precision.HIGHEST)
    return out.reshape(R, K)


def _pick4(x):
    """(R, K) -> (R, K//4) with out[:, g] = x[:, 4g] (block einsum; see
    _stretch4 for why not a strided construction)."""
    R, K = x.shape
    Q = (jnp.arange(512)[:, None]
         == 4 * jnp.arange(128)[None, :]).astype(x.dtype)
    out = jnp.einsum("rbu,uw->rbw", x.reshape(R, K // 512, 512), Q,
                     precision=jax.lax.Precision.HIGHEST)
    return out.reshape(R, K // 4)


def _sum4(x):
    """(R, K) -> (R, K//4) adjacent-4 sums, ascending order per group
    (block einsum: the one-hot contraction accumulates u ascending)."""
    R, K = x.shape
    Q = (jnp.arange(512)[:, None] // 4
         == jnp.arange(128)[None, :]).astype(x.dtype)
    out = jnp.einsum("rbu,uw->rbw", x.reshape(R, K // 512, 512), Q,
                     precision=jax.lax.Precision.HIGHEST)
    return out.reshape(R, K // 4)


def _prec_sum_b(E_prev, alphabet_size: int):
    """X[:, k] = logsumexp_j E_prev[:, prec_j(k)] (batched ntc_pre._prec_sum)."""
    R, K = E_prev.shape
    step = K // alphabet_size
    if K > 4096 and alphabet_size == 4:
        # big-K: stride-step class lse via lane rolls (broadcast form,
        # classes never cross the roll seam: member j + step*i), then a
        # contiguous [0, step) slice + block-einsum stretch — no
        # (A, step)/(step, A) intermediates (see _stretch4)
        v = E_prev
        m1v = jnp.maximum(v, jnp.roll(v, -step, axis=1))
        m = jnp.maximum(m1v, jnp.roll(m1v, -2 * step, axis=1))
        live = m > -jnp.inf
        m_safe = jnp.where(live, m, 0.0)
        e = jnp.exp(v - m_safe)
        s1 = e + jnp.roll(e, -step, axis=1)
        s = s1 + jnp.roll(s1, -2 * step, axis=1)
        m_x = _stretch4(m_safe[:, :step], K)
        s_x = _stretch4(s[:, :step], K)
        return jnp.where(s_x > 0.0, m_x + jnp.log(jnp.where(s_x > 0.0,
                                                            s_x, 1.0)),
                         NEG_INF)
    g = E_prev.reshape(R, alphabet_size, step)
    m = jnp.max(g, axis=1)
    safe_m = jnp.where(jnp.isfinite(m), m, 0.0)
    x = jnp.log(jnp.sum(jnp.exp(g - safe_m[:, None, :]), axis=1)) + safe_m
    x = jnp.where(jnp.isfinite(m), x, NEG_INF)
    return jnp.repeat(x, alphabet_size, axis=1)


def _suc_sum_b(vals, alphabet_size: int):
    """Y[:, k] = logsumexp_j vals[:, suc_j(k)] (batched ntc_pre._suc_sum)."""
    R, K = vals.shape
    step = K // alphabet_size
    if K > 4096 and alphabet_size == 4:
        # big-K: adjacent-4 group max via aligned lane rolls (wraps only
        # reach lanes whose partner is in-group), compact sum/max by
        # block einsum, tile back — no trailing-A intermediates
        lane = jnp.arange(K)[None, :]
        v = vals
        p1 = jnp.where(lane % 2 == 0, jnp.roll(v, -1, axis=1),
                       jnp.roll(v, 1, axis=1))
        m1v = jnp.maximum(v, p1)
        p2 = jnp.where(lane % 4 < 2, jnp.roll(m1v, -2, axis=1),
                       jnp.roll(m1v, 2, axis=1))
        m = jnp.maximum(m1v, p2)                  # group max, broadcast
        live = m > -jnp.inf
        m_safe = jnp.where(live, m, 0.0)
        e = jnp.exp(v - m_safe)
        s_c = _sum4(e)                            # (R, step), ascending
        m_c = _pick4(m_safe)
        y = jnp.where(s_c > 0.0, m_c + jnp.log(jnp.where(s_c > 0.0,
                                                         s_c, 1.0)),
                      NEG_INF)
        return jnp.tile(y, (1, alphabet_size))
    g = vals.reshape(R, step, alphabet_size)
    m = jnp.max(g, axis=2)
    safe_m = jnp.where(jnp.isfinite(m), m, 0.0)
    y = jnp.log(jnp.sum(jnp.exp(g - safe_m[:, :, None]), axis=2)) + safe_m
    y = jnp.where(jnp.isfinite(m), y, NEG_INF)
    return jnp.tile(y, (1, alphabet_size))


def pre_tk_batch(sig, T_r, means, c1, c2, log_m1, log_e2,
                 alphabet_size: int, cap: int, dtype):
    """Batched TK pre-pass: backward stored, forward fused with selection
    (normalization by Zb as in the reference, ref: NTC.cpp:322)."""
    R, Tm1 = sig.shape
    T_pad = Tm1 + 1
    sig = sig.astype(dtype)
    muk = jnp.asarray(means, dtype)
    c1k = jnp.asarray(c1, dtype)
    c2k = jnp.asarray(c2, dtype)
    K = muk.shape[0]

    # ---- backward scan, storing (T, R, K) M/E --------------------------
    def bstep(carry, xs):
        M_next, E_next = carry
        sig_t, t = xs
        d = sig_t[:, None] - muk
        sc = c1k - c2k * d * d
        M_new = E_next + sc
        E_new = jnp.logaddexp(
            _suc_sum_b(M_next + sc + log_m1, alphabet_size),
            E_next + sc + log_e2,
        )
        is_term = (t == T_r - 1)[:, None]
        dead = (t > T_r - 1)[:, None]
        M_out = jnp.where(is_term | dead, NEG_INF, M_new)
        E_out = jnp.where(is_term, 0.0, jnp.where(dead, NEG_INF, E_new))
        # store 2D (R, K): flattening the tiled layout costs a physical
        # relayout gather per step (see pre_tk_batch_ckpt rederive note)
        return (M_out, E_out), (M_out, E_out)

    negK = jnp.full((R, K), NEG_INF, dtype)
    sig_b = jnp.concatenate([sig, jnp.zeros((R, 1), dtype)], axis=1)
    (bM0, bE0), (bM, bE) = jax.lax.scan(
        bstep, (negK, negK), (sig_b.T, jnp.arange(T_pad, dtype=jnp.int32)),
        reverse=True,
    )
    Zb = logsumexp(bE[0], axis=1)

    # ---- forward scan with fused selection -----------------------------
    # one scan over t = 0..T_pad-1 (t=0 selects on the init column); the
    # per-step top_k measured ~2.5x faster end-to-end than hoisting the
    # selection into one big (T*R, K) top_k after the scan
    M0 = negK
    E0 = jnp.zeros((R, K), dtype)

    def fstep(carry, xs):
        M_prev, E_prev, finalE = carry
        sig_t, bM_t, bE_t, t = xs
        d = sig_t[:, None] - muk
        sc = c1k - c2k * d * d
        M_new = _prec_sum_b(E_prev, alphabet_size) + sc + log_m1
        E_new = jnp.logaddexp(M_prev + sc, E_prev + sc + log_e2)
        first = t == 0
        dead = (t > T_r - 1)[:, None]
        M_out = jnp.where(first, M0, jnp.where(dead, NEG_INF, M_new))
        E_out = jnp.where(first, E0, jnp.where(dead, NEG_INF, E_new))
        finalE = jnp.where((t == T_r - 1)[:, None], E_out, finalE)
        U = jnp.logaddexp(bM_t + M_out, bE_t + E_out)
        cand, cnt, ovf = select_topk(
            U, cap, ge_break=True, col_live=t <= T_r - 1, sentinel=K,
        )
        return (M_out, E_out, finalE), (cand, cnt, ovf)

    finalE0 = jnp.where((T_r == 1)[:, None], E0, negK)
    sig_f = jnp.concatenate([jnp.zeros((R, 1), dtype), sig], axis=1)  # sig[t-1]
    xs = (sig_f.T, bM, bE, jnp.arange(T_pad, dtype=jnp.int32))
    (_, _, finalE), (cand, cnt, ovf) = jax.lax.scan(
        fstep, (M0, E0, finalE0), xs
    )
    Zf = logsumexp(finalE, axis=1)
    # k-candidates stay in selection order: every downstream slot lookup is
    # an eq-broadcast (order-agnostic), so no ascending sort is needed
    return PreBatchResult(cand, cnt, Zf, Zb, ovf.any(axis=0))


def pre_tk_batch_ckpt(sig, T_r, means, c1, c2, log_m1, log_e2,
                      alphabet_size: int, cap: int, dtype,
                      chunk: int = 128, sel_cap: int | None = None):
    """pre_tk_batch with O(T/chunk * R * K) memory instead of O(T * R * K):
    the backward pass stores only per-chunk CHECKPOINT states; the fused
    forward/selection pass re-derives each chunk's backward columns from
    its checkpoint (identical op order -> bit-equal to pre_tk_batch) at
    ~1.5x the compute. This is what makes NATIVE 9-mer NTC (K = 4^9,
    ref: NTC_main.cpp:95-99) possible at production read lengths: the
    dense (T, R*K) backward store is ~17 GB per read at T=16k fp32,
    while checkpoints at chunk=128 are ~260 MB (the reference holds four
    T*K double matrices in RAM, NTC.cpp:145-217 — 70 GB at this size).

    sel_cap (<= cap) decouples the SELECTION width from the downstream
    candidate-slot width: the 95%-mass crossing is searched within the
    top sel_cap values only (the 9-mer TK demand is tiny — max 16
    candidates/column measured at T=16k — while the
    lattice geometry wants ~120 slots; top-k cost scales with k), and
    the result is padded to `cap` with sentinels. Columns whose
    crossing lies beyond sel_cap flag overflow exactly like columns
    beyond cap — the overflow ladder re-runs them at full width. The
    selected set is IDENTICAL to the full-cap selection whenever it
    does not overflow."""
    R, Tm1 = sig.shape
    T_pad = Tm1 + 1
    assert T_pad % chunk == 0, (T_pad, chunk)
    if sel_cap is None:
        sel_cap = cap
    assert sel_cap <= cap, (sel_cap, cap)
    nc = T_pad // chunk
    sig = sig.astype(dtype)
    muk = jnp.asarray(means, dtype)
    c1k = jnp.asarray(c1, dtype)
    c2k = jnp.asarray(c2, dtype)
    K = muk.shape[0]
    negK = jnp.full((R, K), NEG_INF, dtype)

    def bstep(carry, xs):
        M_next, E_next = carry
        sig_t, t = xs
        d = sig_t[:, None] - muk
        sc = c1k - c2k * d * d
        M_new = E_next + sc
        E_new = jnp.logaddexp(
            _suc_sum_b(M_next + sc + log_m1, alphabet_size),
            E_next + sc + log_e2,
        )
        is_term = (t == T_r - 1)[:, None]
        dead = (t > T_r - 1)[:, None]
        M_out = jnp.where(is_term | dead, NEG_INF, M_new)
        E_out = jnp.where(is_term, 0.0, jnp.where(dead, NEG_INF, E_new))
        return (M_out, E_out), None

    sig_b = jnp.concatenate([sig, jnp.zeros((R, 1), dtype)], axis=1)
    ts = jnp.arange(T_pad, dtype=jnp.int32)
    xsb = (sig_b.T.reshape(nc, chunk, R), ts.reshape(nc, chunk))

    def bchunk(carry, xs):
        new, _ = jax.lax.scan(bstep, carry, xs, reverse=True)
        # checkpoint = state entering this chunk, carried FLAT (R*K,)
        return new, (carry[0].reshape(-1), carry[1].reshape(-1))

    (_, bE0), ckpts = jax.lax.scan(bchunk, (negK, negK), xsb, reverse=True)
    Zb = logsumexp(bE0, axis=1)

    M0 = negK
    E0 = jnp.zeros((R, K), dtype)

    def bstep_store(carry, xs):
        new, _ = bstep(carry, xs)
        # 2D (R, K) ys; the (chunk, R, K) stack lives only inside one
        # fchunk body
        return new, (new[0], new[1])

    def fstep(carry, xs):
        M_prev, E_prev, finalE = carry
        sig_t, bM_t, bE_t, t = xs
        d = sig_t[:, None] - muk
        sc = c1k - c2k * d * d
        M_new = _prec_sum_b(E_prev, alphabet_size) + sc + log_m1
        E_new = jnp.logaddexp(M_prev + sc, E_prev + sc + log_e2)
        first = t == 0
        dead = (t > T_r - 1)[:, None]
        M_out = jnp.where(first, M0, jnp.where(dead, NEG_INF, M_new))
        E_out = jnp.where(first, E0, jnp.where(dead, NEG_INF, E_new))
        finalE = jnp.where((t == T_r - 1)[:, None], E_out, finalE)
        U = jnp.logaddexp(bM_t + M_out, bE_t + E_out)
        cand, cnt, ovf = select_topk(
            U, sel_cap, ge_break=True, col_live=t <= T_r - 1, sentinel=K,
        )
        return (M_out, E_out, finalE), (cand, cnt, ovf)

    finalE0 = jnp.where((T_r == 1)[:, None], E0, negK)
    sig_f = jnp.concatenate([jnp.zeros((R, 1), dtype), sig], axis=1)
    xsf_sig = sig_f.T.reshape(nc, chunk, R)

    def fchunk(carry, xs):
        xsb_c, xsf_c, ts_c, ck_flat = xs
        ck = (ck_flat[0].reshape(R, K), ck_flat[1].reshape(R, K))
        # re-derive this chunk's backward columns from the checkpoint
        # (same ops as the checkpoint pass -> bit-equal values)
        _, (bMc, bEc) = jax.lax.scan(bstep_store, ck, (xsb_c, ts_c),
                                     reverse=True)
        return jax.lax.scan(fstep, carry, (xsf_c, bMc, bEc, ts_c))

    (_, _, finalE), (cand, cnt, ovf) = jax.lax.scan(
        fchunk, (M0, E0, finalE0), (xsb[0], xsf_sig, xsb[1], ckpts)
    )
    Zf = logsumexp(finalE, axis=1)
    T_ = T_pad
    cand = cand.reshape(T_, R, sel_cap)
    if sel_cap < cap:
        # pad the slot axis back to `cap` with sentinels so downstream
        # plan shapes are independent of the selection width
        cand = jnp.concatenate(
            [cand, jnp.full((T_, R, cap - sel_cap), K, cand.dtype)],
            axis=2)
    return PreBatchResult(
        cand, cnt.reshape(T_, R), Zf, Zb,
        ovf.reshape(T_, R).any(axis=0),
    )


# ---------------------------------------------------------------------------
# batched plan build (ref layout: ops/ntc_dp.build_plan)
# ---------------------------------------------------------------------------

def _build_plan_one(cand_n, cnt_n, cand_k0, cnt_k, kmer_seq, N_read,
                    means, c1, c2, alphabet_size: int, kmer_size: int, dtype,
                    bigk: bool = False, kn1=None, kn2=None):
    """Single-read plan with a *traced* read length N_read (the static
    N = N_max only bounds shapes/clipping); otherwise identical to
    ops/ntc_dp.build_plan. vmapped over reads by build_plan_batch."""
    T, CN = cand_n.shape
    K = means.shape[0]
    N_max = kmer_seq.shape[0] + 1
    step = K // alphabet_size

    n_valid = (jnp.arange(CN)[None, :] < cnt_n[:, None]) & (cand_n < N_read[None])
    n_safe = jnp.clip(cand_n, 0, N_max - 1)
    # kn1/kn2: kmer_seq[cand-1]/[cand] when the pre-pass already
    # extracted them (co-sorted with cand)
    kN_raw = kn1 if kn1 is not None else \
        kmer_seq[jnp.clip(n_safe - 1, 0, N_max - 2)]
    kN = jnp.where(n_valid & (cand_n >= 1), kN_raw, 0)
    base_k = jnp.where(n_valid & (cand_n >= 1), kN, K)

    # k-slot list: TK candidates (selection order) ++ the read's own kmer
    # per n-slot. No sort — slot lookups go through a first-slot-wins
    # inverse table (built once here, reused for the k-maps below), and a
    # slot is a duplicate iff it is not its own value's first slot.
    ks = jnp.concatenate([cand_k0, base_k], axis=1).astype(jnp.int32)
    CKm = ks.shape[1]
    t_iota = jnp.arange(T)[:, None]
    slot_iota = jnp.arange(CKm, dtype=jnp.int32)[None]
    CK0 = cand_k0.shape[1]
    if bigk:
        # dedup without the (T, CKm, CKm) eq-broadcast: the TK block comes
        # from lax.top_k, whose indices are DISTINCT by construction
        # (invalid entries are the sentinel K, which never equals a live
        # value), so only the CN base slots can duplicate — against the
        # TK block or an earlier base slot
        live0 = cand_k0 < K                              # (T, CK0)
        dup_tk = (base_k[:, :, None] == cand_k0[:, None, :]).any(-1)
        sl_b = jnp.arange(CN)
        dup_b = (
            (base_k[:, :, None] == base_k[:, None, :])
            & (sl_b[None, :, None] < sl_b[None, None, :])
        ).any(1)                                         # earlier equal slot
        live_b = (base_k < K) & ~dup_tk & ~dup_b
        live = jnp.concatenate([live0, live_b], axis=1)
        # from_tk only matters for LIVE slots (allowed requires live):
        # live TK slots are from_tk by definition; live base slots are
        # not in the TK block (they'd be dup_tk-dead otherwise)
        from_tk = jnp.concatenate(
            [live0, jnp.zeros_like(live_b)], axis=1)
    else:
        slot_tab = jnp.full((T, K + 1), CKm, jnp.int32)
        slot_tab = slot_tab.at[t_iota, ks].min(
            jnp.broadcast_to(slot_iota, ks.shape), mode="drop",
        )
        slot_tab = slot_tab.at[:, K].set(CKm)
        first_slot = jnp.take_along_axis(slot_tab, jnp.clip(ks, 0, K), axis=1)
        live = (first_slot == slot_iota) & (ks < K)
        k_valid0 = jnp.arange(CK0)[None, :] < cnt_k[:, None]
        ck0 = jnp.where(k_valid0, cand_k0, K)
        # membership via a per-column dense bool table over kmer values:
        # one scatter + one gather instead of a (T, CKm, CK0) eq-broadcast
        # (which XLA materializes -> ~1 GB of HBM traffic per read)
        is_tk = jnp.zeros((T, K + 1), bool).at[t_iota, ck0].set(
            True, mode="drop"
        )
        is_tk = is_tk.at[:, K].set(False)
        from_tk = jnp.take_along_axis(is_tk, jnp.clip(ks, 0, K), axis=1)

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
    kN2_raw = kn2 if kn2 is not None else \
        kmer_seq[jnp.clip(n_safe, 0, N_max - 2)]
    kN2 = jnp.where(n_valid & (cand_n < N_read[None] - 1), kN2_raw, 0)

    def hd_count(a, b, ndigits):
        acc = jnp.zeros(jnp.broadcast_shapes(a.shape, b.shape), jnp.int32)
        x, y = a, b
        for _ in range(ndigits):
            acc = acc + (
                (x % alphabet_size) != (y % alphabet_size)
            ).astype(jnp.int32)
            x = x // alphabet_size
            y = y // alphabet_size
        return acc.astype(jnp.int8)

    # Hamming tables (see NTCPlan): hoists all in-scan hamming2 calls —
    # including the 2*A successor variants of the backward pass — into
    # per-(t, slot-pair) int8 lookups built once per bucket
    kNc, kN2c = kN[:, :, None], kN2[:, :, None]
    ksc = ks_safe[:, None, :]
    hd1 = hd_count(kNc, ksc, kmer_size)
    hd2 = hd_count(kN2c, ksc, kmer_size)
    hd1s = hd_count(kNc // alphabet_size, ksc, kmer_size - 1)
    hd2s = hd_count(kN2c // alphabet_size, ksc, kmer_size - 1)
    d01 = (kN % alphabet_size).astype(jnp.int8)
    d02 = (kN2 % alphabet_size).astype(jnp.int8)

    # (T, CK, A) quantities are built and kept FLAT as (T, A*CK) in
    # A-MAJOR order (index ai*CK + ck), so the scan bodies slice
    # per-alphabet (R, CK) pieces with static slices.
    arange_a = jnp.arange(alphabet_size, dtype=ks.dtype)
    suc_base = (ks_safe % step) * alphabet_size
    suc_flat = (suc_base[:, None, :] + arange_a[None, :, None]).reshape(T, -1)

    prev_n = jnp.concatenate([jnp.full((1, CN), N_max, cand_n.dtype), cand_n[:-1]], 0)
    next_n = jnp.concatenate([cand_n[1:], jnp.full((1, CN), N_max, cand_n.dtype)], 0)

    def slot2(values, table):
        """First slot of each value in the per-column table, -1 if absent.
        Dense eq-broadcast — fine for the CN=8-wide n-tables."""
        eq = values[:, :, None] == table[:, None, :]
        found = eq.any(-1)
        return jnp.where(found, jnp.argmax(eq, -1).astype(jnp.int32), -1)

    if bigk:
        # big-K (native 9-mer): the (T, K+1) scatter tables below are
        # ~17 GB per read at K=4^9, T=16k — build the k-maps as direct
        # slot-level eq-broadcasts instead (O(T*CKm^2*A) ~ 1 GB, fine
        # for the R=1 buckets big-K mode runs in). First matching slot
        # == the scatter-min's first-slot-wins result.
        prec_base = ks_safe // alphabet_size
        prec_flat = (
            prec_base[:, None, :] + (arange_a * step)[None, :, None]
        ).reshape(T, -1)
        src = jnp.where(ks < K, ks, -1)
        none_col = jnp.full((1, CKm), -1, src.dtype)
        prev_src = jnp.concatenate([none_col, src[:-1]], 0)
        next_src = jnp.concatenate([src[1:], none_col], 0)

        def kslot_eq(col_src, values):
            val = jnp.where(values < K, values, -2)
            eq = col_src[:, None, :] == val[:, :, None]
            found = eq.any(-1)
            return jnp.where(
                found, jnp.argmax(eq, -1).astype(jnp.int32), -1)

        col_same = kslot_eq(prev_src, ks)
        col_prec = kslot_eq(prev_src, prec_flat)
        bcol_same = kslot_eq(next_src, ks)
        bcol_suc = kslot_eq(next_src, suc_flat)
    else:
        prec_base = ks_safe // alphabet_size
        prec_flat = (
            prec_base[:, None, :] + (arange_a * step)[None, :, None]
        ).reshape(T, -1)
        # k-maps via the same per-column inverse lookup (slot_tab above):
        # ONE scatter-min table (first slot wins, dead duplicates lose) +
        # cheap gathers, instead of (T, CKm|CKm*A, CKm) eq-broadcasts that
        # cost gigabytes of HBM traffic per read. Column K = sentinel.
        rowCK = jnp.full((1, K + 1), CKm, jnp.int32)
        prev_tab = jnp.concatenate([rowCK, slot_tab[:-1]], 0)
        next_tab = jnp.concatenate([slot_tab[1:], rowCK], 0)

        def kslot(tab, values):
            got = jnp.take_along_axis(tab, jnp.clip(values, 0, K), axis=1)
            return jnp.where(got < CKm, got, -1)

        col_same = kslot(prev_tab, ks)
        col_prec = kslot(prev_tab, prec_flat)
        bcol_same = kslot(next_tab, ks)
        bcol_suc = kslot(next_tab, suc_flat)

    mu_k, c1_k, c2_k = means[ks_safe], c1[ks_safe], c2[ks_safe]
    mu_suc, c1_suc, c2_suc = means[suc_flat], c1[suc_flat], c2[suc_flat]
    mu_n, c1_n, c2_n = means[kN], c1[kN], c2[kN]
    mu_n2, c1_n2, c2_n2 = means[kN2], c1[kN2], c2[kN2]
    suc_vals = suc_flat.astype(jnp.int32)
    return NTCPlan(
        cand_n=cand_n.astype(jnp.int32), cnt_n=cnt_n.astype(jnp.int32),
        ks=ks, live=live, from_tk=from_tk, allowed=allowed,
        mu_k=mu_k, c1_k=c1_k, c2_k=c2_k,
        kN=kN.astype(jnp.int32), mu_n=mu_n, c1_n=c1_n, c2_n=c2_n,
        kN2=kN2.astype(jnp.int32), mu_n2=mu_n2, c1_n2=c1_n2, c2_n2=c2_n2,
        row_same=slot2(cand_n, prev_n), row_prev=slot2(cand_n - 1, prev_n),
        col_same=col_same, col_prec=col_prec,
        brow_same=slot2(cand_n, next_n), brow_next=slot2(cand_n + 1, next_n),
        bcol_same=bcol_same, bcol_suc=bcol_suc,
        suc_vals=suc_vals,
        mu_suc=mu_suc, c1_suc=c1_suc, c2_suc=c2_suc,
        hd1=hd1, hd2=hd2, hd1s=hd1s, hd2s=hd2s, d01=d01, d02=d02,
    )


class PlanDims(NamedTuple):
    """Static slot-layout dimensions of a flattened batched plan."""

    R: int
    CN: int
    CK: int
    A: int


def build_plan_batch(cand_n, cnt_n, cand_k0, cnt_k, kmer_ids, N_r,
                     means, c1, c2, alphabet_size: int, kmer_size: int,
                     dtype, bigk: bool = False, kn1=None, kn2=None):
    """cand_n (T, R, CN), cnt_n (T, R), cand_k0 (T, R, CK0), cnt_k (T, R),
    kmer_ids (R, N_max-1), N_r (R,). kn1/kn2 (T, R, CN) optional
    pre-extracted kmer_seq values at cand-1/cand (PreBatchResult).

    Returns (plan, dims) where every plan array is FLATTENED to (T, X);
    scan bodies reshape single rows back."""
    if kn1 is not None:
        fn = jax.vmap(
            lambda a, b, c, d, ks, n, k1, k2: _build_plan_one(
                a, b, c, d, ks, n, means, c1, c2, alphabet_size,
                kmer_size, dtype, bigk=bigk, kn1=k1, kn2=k2,
            ),
            in_axes=(1, 1, 1, 1, 0, 0, 1, 1), out_axes=1,
        )
        plan = fn(cand_n, cnt_n, cand_k0, cnt_k, kmer_ids, N_r, kn1, kn2)
        R, CN = plan.cand_n.shape[1:3]
        CK = plan.ks.shape[2]
        dims = PlanDims(R, CN, CK, alphabet_size)
        flat = NTCPlan(*[a.reshape(a.shape[0], -1) for a in plan])
        return flat, dims
    fn = jax.vmap(
        lambda a, b, c, d, ks, n: _build_plan_one(
            a, b, c, d, ks, n, means, c1, c2, alphabet_size, kmer_size,
            dtype, bigk=bigk,
        ),
        in_axes=(1, 1, 1, 1, 0, 0), out_axes=1,
    )
    plan = fn(cand_n, cnt_n, cand_k0, cnt_k, kmer_ids, N_r)
    R, CN = plan.cand_n.shape[1:3]
    CK = plan.ks.shape[2]
    dims = PlanDims(R, CN, CK, alphabet_size)
    flat = NTCPlan(*[a.reshape(a.shape[0], -1) for a in plan])
    return flat, dims


# ---------------------------------------------------------------------------
# batched 3D DP (ref: NTC.cpp:417-578; slot layout: ops/ntc_dp.py)
# ---------------------------------------------------------------------------

_NEG_BIG = -1e30   # finite -inf proxy inside one-hot matmuls (0*-inf = nan)
_NEG_THR = -5e29   # anything at or below this came from a clamped -inf


def _gr(x, row_idx):
    """x (R, 5, CN, CK), row_idx (R, CN) -> gather rows, -inf where idx<0.

    One-hot matmul (it measured faster than take_along_axis on an H100,
    see _stretch4). -inf inputs are clamped to a finite proxy for the multiply
    and restored exactly afterwards (log-probs never approach -5e29), so
    the result is bit-identical to the gather."""
    dt = x.dtype
    CN = x.shape[2]
    oh = (row_idx[:, :, None]
          == jnp.arange(CN, dtype=row_idx.dtype)[None, None, :]).astype(dt)
    xc = jnp.maximum(x, jnp.asarray(_NEG_BIG, dt))
    # HIGHEST: a default-precision fp32 matmul may round its operands
    # (TF32 on the GPU), which would truncate the gathered log-probs
    g = jnp.einsum('rmn,rsnk->rsmk', oh, xc, preferred_element_type=dt,
                   precision=jax.lax.Precision.HIGHEST)
    g = jnp.where(g <= jnp.asarray(_NEG_THR, dt), NEG_INF, g)
    return jnp.where((row_idx >= 0)[:, None, :, None], g, NEG_INF)


def _gc(x, col_idx):
    """x (R, X, CN, CK), col_idx (R, CKo) -> gather cols, -inf where idx<0.

    One-hot matmul (see _gr); contraction over the source CK axis yields
    (R, X, CN, CKo) directly, no transpose. X is ANY stack of source rows
    that share the target index set: the scan bodies stack exactly the
    (state, row-gather) combinations they consume onto this axis so each
    target index set builds ONE one-hot and runs ONE einsum (the naive
    per-source-state form gathered all 5 states per call and discarded
    most — 5x the MACs on the A*CK-wide successor gathers)."""
    dt = x.dtype
    CK = x.shape[3]
    oh = (col_idx[:, None, :]
          == jnp.arange(CK, dtype=col_idx.dtype)[None, :, None]).astype(dt)
    xc = jnp.maximum(x, jnp.asarray(_NEG_BIG, dt))
    g = jnp.einsum('rsnj,rjm->rsnm', xc, oh, preferred_element_type=dt,
                   precision=jax.lax.Precision.HIGHEST)
    g = jnp.where(g <= jnp.asarray(_NEG_THR, dt), NEG_INF, g)
    return jnp.where((col_idx >= 0)[:, None, None, :], g, NEG_INF)


def _aff_log(x, y):
    """Composition of log-affine maps v -> logaddexp(a, v + b); x applies
    first. Used to run the in-column I chains as associative scans over the
    CN axis instead of a CN-unrolled Python loop (the scan bodies are
    bound by op count per step, not FLOPs)."""
    a1, b1 = x
    a2, b2 = y
    return jnp.logaddexp(a2, a1 + b2), b1 + b2


def _aff_max(x, y):
    """Max-plus variant of _aff_log (Viterbi I chain)."""
    a1, b1 = x
    a2, b2 = y
    return jnp.maximum(a2, a1 + b2), b1 + b2


def _fwd_column(prev, xs_t, tl, dims: PlanDims, kmer_size, dtype):
    """One forward column update (R, 5, CN, CK) -> same; the exact batched
    transcription of ops/ntc_dp.ntc_forward's scan body. xs rows arrive
    flattened (see build_plan_batch) and are reshaped here."""
    R, CN, CK, alphabet_size = dims
    A = alphabet_size
    (sig_t, cn, allowed, mu_k, c1_k, c2_k, hd1, mu_n, c1_n, c2_n,
     row_same, row_prev, col_same, col_prec) = xs_t
    cn = cn.reshape(R, CN)
    allowed = allowed.reshape(R, CN, CK)
    mu_k, c1_k, c2_k = (a.reshape(R, CK) for a in (mu_k, c1_k, c2_k))
    mu_n, c1_n, c2_n = (a.reshape(R, CN) for a in (mu_n, c1_n, c2_n))
    row_same = row_same.reshape(R, CN)
    row_prev = row_prev.reshape(R, CN)
    col_same = col_same.reshape(R, CK)
    col_prec = col_prec.reshape(R, CK * A)  # flat: one batched gather

    d_n = sig_t[:, None] - mu_n
    sc_n = c1_n - c2_n * d_n * d_n
    d_k = sig_t[:, None] - mu_k
    sc_k = c1_k - c2_k * d_k * d_k
    hd = -2.0 * hd1.reshape(R, CN, CK).astype(dtype)
    sc = sc_n[:, :, None] + sc_k[:, None, :] + hd

    ge_same = _gr(prev, row_same)
    ge_prev = _gr(prev, row_prev)

    # alphabet-batched predecessor gathers: exactly the consumed
    # (row-gather, state) pairs stack on the X axis of ONE einsum per
    # target index set (see _gc)
    gprec = _gc(
        jnp.stack([ge_prev[:, E_ST], ge_prev[:, I_ST], ge_same[:, S_ST],
                   ge_same[:, E_ST], ge_same[:, I_ST]], axis=1),
        col_prec,
    )  # (R, 5, CN, A*CK)
    sl = lambda g, x, ai: g[:, x, :, ai * CK:(ai + 1) * CK]
    a_terms = [t for ai in range(A)
               for t in (sl(gprec, 0, ai) + tl["a1"],
                         sl(gprec, 1, ai) + tl["a2"])]
    a_acc = logsumexp(jnp.stack(a_terms, axis=0), axis=0)
    p_terms = [t for ai in range(A)
               for t in (sl(gprec, 2, ai) + tl["p1"],
                         sl(gprec, 3, ai) + tl["p2"],
                         sl(gprec, 4, ai) + tl["p3"])]
    p_acc = logsumexp(jnp.stack(p_terms, axis=0), axis=0)
    a_new = a_acc + sc
    p_new = p_acc + sc

    gsame = _gc(
        jnp.stack([ge_prev[:, P_ST], ge_prev[:, E_ST], ge_prev[:, I_ST],
                   ge_same[:, A_ST], ge_same[:, P_ST], ge_same[:, S_ST],
                   ge_same[:, E_ST]], axis=1),
        col_same,
    )  # (R, 7, CN, CK)
    s_new = (
        logsumexp(
            jnp.stack(
                [gsame[:, 0] + tl["s1"], gsame[:, 1] + tl["s2"],
                 gsame[:, 2] + tl["s3"]], axis=0,
            ),
            axis=0,
        )
        + sc
    )
    e_new = (
        logsumexp(
            jnp.stack(
                [gsame[:, 3], gsame[:, 4] + tl["e2"],
                 gsame[:, 5] + tl["e3"], gsame[:, 6] + tl["e4"]], axis=0,
            ),
            axis=0,
        )
        + sc
    )

    n_pos = (cn >= 1)[:, :, None]
    ok = allowed & n_pos
    a_new = jnp.where(ok, a_new, NEG_INF)
    p_new = jnp.where(ok, p_new, NEG_INF)
    s_new = jnp.where(ok, s_new, NEG_INF)
    e_new = jnp.where(ok, e_new, NEG_INF)

    # I: in-column chain over n-slots (ref: NTC.cpp:474-477) as a
    # log-affine associative scan: i[s] = LA(e[s-1]+i1+sc, i[s-1]+i2+sc)
    e_above = jnp.concatenate(
        [jnp.full((R, 1, CK), NEG_INF, dtype), e_new[:, :-1]], axis=1
    )
    chain = jnp.concatenate(
        [jnp.zeros((R, 1), bool), cn[:, :-1] == cn[:, 1:] - 1], axis=1
    )
    cond = chain[:, :, None] & ok
    iA = jnp.where(cond, e_above + tl["i1"] + sc, NEG_INF)
    iB = jnp.where(cond, tl["i2"] + sc, NEG_INF)
    i_new, _ = jax.lax.associative_scan(_aff_log, (iA, iB), axis=1)

    return jnp.stack([a_new, p_new, s_new, e_new, i_new], axis=1)


def _fwd_xs(plan: NTCPlan, sig):
    """Stream slices for forward scans over t = 0..T_pad-1 (T-major, no
    slicing — a [1:] of the plan tensors would copy them wholesale).
    sig is padded in front so row t carries sig[t-1]."""
    R = sig.shape[0]
    sig_f = jnp.concatenate([jnp.zeros((R, 1), sig.dtype), sig], axis=1)
    return (
        sig_f.T, plan.cand_n, plan.allowed,
        plan.mu_k, plan.c1_k, plan.c2_k, plan.hd1,
        plan.mu_n, plan.c1_n, plan.c2_n,
        plan.row_same, plan.row_prev, plan.col_same,
        plan.col_prec,
    )


def _init_column(plan: NTCPlan, dims: PlanDims, dtype):
    """t = 0: E = 0 at rows with n == 0, allowed slots."""
    R, CN, CK, _ = dims
    init = jnp.full((R, 5, CN, CK), NEG_INF, dtype)
    cn0 = plan.cand_n[0].reshape(R, CN)
    allowed0 = plan.allowed[0].reshape(R, CN, CK).astype(bool)
    row0 = (cn0 == 0)[:, :, None] & allowed0
    return init.at[:, E_ST].set(jnp.where(row0, 0.0, NEG_INF))


def _final_row_masks(plan: NTCPlan, dims: PlanDims, N_r, T_r):
    """Masks/rows of the terminal column t = T_r-1, gathered per read."""
    R, CN, CK, _ = dims

    def tak(a, per):
        # flat (T, R*per) layout: column x belongs to read x // per
        idx = jnp.repeat(T_r - 1, per)[None, :]
        return jnp.take_along_axis(a, idx, axis=0)[0]

    cand_last = tak(plan.cand_n, CN).reshape(R, CN)
    allowed_last = tak(plan.allowed, CN * CK).reshape(R, CN, CK).astype(bool)
    live_last = tak(plan.live, CK).reshape(R, CK)
    mask = (
        (cand_last == (N_r - 1)[:, None])[:, :, None]
        & allowed_last & live_last[:, None, :]
    )
    return cand_last, allowed_last, live_last, mask


def ntc_backward_batch(plan: NTCPlan, dims: PlanDims, sig, trans_log,
                       N_r, T_r, kmer_size: int, dtype):
    """Backward pass storing flat (T, R, 5*CN*CK); ragged-T terminal
    injection. Exact batched transcription of ops/ntc_dp.ntc_backward."""
    T_pad = plan.cand_n.shape[0]
    R, CN, CK, alphabet_size = dims
    tl = trans_log

    def step(carry, xs):
        nxt = carry
        (sig_t, sig_tm1, t, cn, allowed, mu_k, c1_k, c2_k, mu_n,
         c1_n, c2_n, mu_n2, c1_n2, c2_n2, hd1t, hd2t, hd1st, hd2st,
         d01, d02, brow_same, brow_next,
         bcol_same, bcol_suc, mu_suc, c1_suc, c2_suc) = xs
        A = alphabet_size
        cn = cn.reshape(R, CN)
        allowed = allowed.reshape(R, CN, CK)
        mu_k, c1_k, c2_k = (a.reshape(R, CK) for a in (mu_k, c1_k, c2_k))
        mu_n, c1_n, c2_n = (
            a.reshape(R, CN) for a in (mu_n, c1_n, c2_n))
        mu_n2, c1_n2, c2_n2 = (
            a.reshape(R, CN) for a in (mu_n2, c1_n2, c2_n2))
        hd1 = -2.0 * hd1t.reshape(R, CN, CK).astype(dtype)
        hd2 = -2.0 * hd2t.reshape(R, CN, CK).astype(dtype)
        hd1s = hd1st.reshape(R, CN, CK).astype(dtype)
        hd2s = hd2st.reshape(R, CN, CK).astype(dtype)
        d01 = d01.reshape(R, CN)
        d02 = d02.reshape(R, CN)
        brow_same = brow_same.reshape(R, CN)
        brow_next = brow_next.reshape(R, CN)
        bcol_same = bcol_same.reshape(R, CK)
        bcol_suc = bcol_suc.reshape(R, CK * A)  # flat: one batched gather
        mu_suc, c1_suc, c2_suc = (
            a.reshape(R, CK * A) for a in (mu_suc, c1_suc, c2_suc))

        d_n = sig_t[:, None] - mu_n
        scn = c1_n - c2_n * d_n * d_n
        d_n2 = sig_t[:, None] - mu_n2
        scn2 = c1_n2 - c2_n2 * d_n2 * d_n2
        d_k = sig_t[:, None] - mu_k
        sck = c1_k - c2_k * d_k * d_k
        sc1 = scn[:, :, None] + sck[:, None, :] + hd1
        sc2 = scn2[:, :, None] + sck[:, None, :] + hd2

        gn_same = _gr(nxt, brow_same)
        gn_next = _gr(nxt, brow_next)
        gk = _gc(jnp.stack([gn_same[:, E_ST], gn_next[:, S_ST]], axis=1),
                 bcol_same)  # (R, 2, CN, CK): [E of same-row, S of next-row]

        n_pos = (cn >= 1)[:, :, None]
        n_lt = (cn < (N_r - 1)[:, None])[:, :, None]
        a_new = jnp.where(n_pos, gk[:, 0] + sc1, NEG_INF)
        p_new = jnp.logaddexp(
            jnp.where(n_pos, gk[:, 0] + tl["e2"] + sc1, NEG_INF),
            jnp.where(n_lt, gk[:, 1] + tl["s1"] + sc2, NEG_INF),
        )
        # alphabet-batched successor terms (the ai-unrolled gathers cost
        # ~4x the HLO ops); A-major flat layouts keep every transient
        # free of trailing small axes (tile-relayout trap), and candidate
        # terms stack on axis 0. Only P-of-same-row and A-of-next-row are
        # consumed: stacking just those makes the A*CK-wide einsum 5x
        # smaller than gathering all states.
        d_s = sig_t[:, None] - mu_suc
        scs = c1_suc - c2_suc * d_s * d_s          # (R, A*CK) A-major
        gsuc = _gc(jnp.stack([gn_same[:, P_ST], gn_next[:, A_ST]], axis=1),
                   bcol_suc)                       # (R, 2, CN, A*CK)
        base_s = jnp.where(n_pos, gk[:, 0] + tl["e3"] + sc1, NEG_INF)
        base_e = jnp.where(n_pos, gk[:, 0] + tl["e4"] + sc1, NEG_INF)
        gnkS = gk[:, 1] + sc2
        s_terms = [base_s]
        e_terms = [base_e]
        i_terms = []
        for ai in range(A):
            scs_ai = scs[:, None, ai * CK:(ai + 1) * CK]
            # HD vs the a-successor of k_j decomposes into the shifted
            # table + a first-digit mismatch (see NTCPlan.hd1s)
            m1 = (d01 != ai).astype(dtype)[:, :, None]
            m2 = (d02 != ai).astype(dtype)[:, :, None]
            sc1s = scn[:, :, None] + scs_ai - 2.0 * (hd1s + m1)
            sc2s = scn2[:, :, None] + scs_ai - 2.0 * (hd2s + m2)
            gspP = jnp.where(
                n_pos, gsuc[:, 0, :, ai * CK:(ai + 1) * CK] + sc1s, NEG_INF
            )
            gnaA = jnp.where(
                n_lt, gsuc[:, 1, :, ai * CK:(ai + 1) * CK] + sc2s, NEG_INF
            )
            s_terms.append(gspP + tl["p1"])
            e_terms.append(gspP + tl["p2"])
            e_terms.append(gnaA + tl["a1"])
            i_terms.append(gspP + tl["p3"])
            i_terms.append(gnaA + tl["a2"])
        e_terms.append(jnp.where(n_lt, gnkS + tl["s2"], NEG_INF))
        i_terms.append(jnp.where(n_lt, gnkS + tl["s3"], NEG_INF))
        s_new = logsumexp(jnp.stack(s_terms, axis=0), axis=0)
        e_new = logsumexp(jnp.stack(e_terms, axis=0), axis=0)
        i_new = logsumexp(jnp.stack(i_terms, axis=0), axis=0)

        # same-t I chain (ref: NTC.cpp:565-572): sig[t-1] and kmerSeq[n],
        # run as a log-affine associative scan from high to low slot
        d_km1 = sig_tm1[:, None] - mu_k
        sck_m1 = c1_k - c2_k * d_km1 * d_km1
        d_nm1 = sig_tm1[:, None] - mu_n2
        scn2_m1 = c1_n2 - c2_n2 * d_nm1 * d_nm1
        sc_i = scn2_m1[:, :, None] + sck_m1[:, None, :] + hd2
        t_pos = t > 0
        chain_up = jnp.concatenate(
            [cn[:, 1:] == cn[:, :-1] + 1, jnp.zeros((R, 1), bool)], axis=1
        )
        ok_i = (
            chain_up & t_pos[None] & (cn < (N_r - 1)[:, None])
        )[:, :, None]
        iB = jnp.where(ok_i, tl["i2"] + sc_i, NEG_INF)
        rev = lambda x: jnp.flip(x, axis=1)
        i_full, _ = jax.lax.associative_scan(
            _aff_log, (rev(i_new), rev(iB)), axis=1
        )
        i_full = rev(i_full)
        # e uses the UPDATED i of the slot above: shift i_full down by one
        i_below = jnp.concatenate(
            [i_full[:, 1:], jnp.full((R, 1, CK), NEG_INF, dtype)], axis=1
        )
        e_new = jnp.logaddexp(
            e_new, jnp.where(ok_i, i_below + tl["i1"] + sc_i, NEG_INF)
        )
        i_new = i_full

        computed = jnp.stack([a_new, p_new, s_new, e_new, i_new], axis=1)
        computed = jnp.where(allowed[:, None], computed, NEG_INF)

        # ragged-T: terminal column at t == T_r-1, dead above
        is_term = (t == T_r - 1)[:, None, None, None]
        dead = (t > T_r - 1)[:, None, None, None]
        rowN = (cn == (N_r - 1)[:, None])[:, :, None] & allowed
        term = jnp.full_like(computed, NEG_INF)
        term = term.at[:, E_ST].set(jnp.where(rowN, 0.0, NEG_INF))
        out = jnp.where(is_term, term, jnp.where(dead, NEG_INF, computed))
        return out, out.reshape(R, -1)  # store flat (see build_plan_batch)

    sig_pad = jnp.concatenate([sig.astype(dtype), jnp.zeros((sig.shape[0], 1), dtype)], 1)
    sig_prev = jnp.concatenate([jnp.zeros((sig.shape[0], 1), dtype), sig_pad[:, :-1]], 1)
    xs = (
        sig_pad.T, sig_prev.T, jnp.arange(T_pad, dtype=jnp.int32),
        plan.cand_n, plan.allowed,
        plan.mu_k, plan.c1_k, plan.c2_k,
        plan.mu_n, plan.c1_n, plan.c2_n,
        plan.mu_n2, plan.c1_n2, plan.c2_n2,
        plan.hd1, plan.hd2, plan.hd1s, plan.hd2s, plan.d01, plan.d02,
        plan.brow_same, plan.brow_next, plan.bcol_same,
        plan.bcol_suc,
        plan.mu_suc, plan.c1_suc, plan.c2_suc,
    )
    init = jnp.full((R, 5, CN, CK), NEG_INF, dtype)
    _, bwd = jax.lax.scan(step, init, xs, reverse=True)
    return bwd  # (T_pad, R, 5*CN*CK) flat


def _first_match(cands, dtype):
    """max + first-index-achieving-max over an ordered candidate list —
    the walk's check order becomes the stored choice (ref equality-check
    order in NTC.cpp:691-904). Candidates stack on axis 0."""
    c = jnp.stack(cands, axis=0)
    m = jnp.max(c, axis=0)
    # argmax returns the FIRST index attaining the max — the check order
    code = jnp.argmax(c == m[None], axis=0).astype(jnp.int32)
    return m, code


def ntc_posterior_viterbi_batch(plan: NTCPlan, dims: PlanDims, sig, bwd,
                                Z_norm, trans_log, N_r, T_r, kmer_size: int,
                                dtype):
    """THE forward scan: compute fwd columns, emit posteriors
    lp = fwd + bwd - lse_col(fwd + bwd) and the Viterbi max-DP choice bits
    in one pass (ref getBorders: NTC.cpp:595-669; choices replace the
    reference's equality-check walk, see ops/ntc_walk). The per-column
    normalizer equals the reference's global Z (NTC_main.cpp:186) by the
    forward-backward identity but is fp32-stable at T=16k (see the step
    body). Z_norm (Zb from the stored backward pass) is kept in the
    signature for the engine's Zf/Zb consistency gate plumbing; the
    terminal forward E column is returned so the caller can still compute
    Zf for that check (the reference asserts |Zf-Zb| <= EPSILON*cells,
    NTC_main.cpp:168-175).

    Returns (lp (T, R, 5*CN*CK) flat, choices (T, R, CN*CK) flat packed
    int32, ap_final_E (R, CN, CK), fwd_final_E (R, CN, CK))."""
    T_pad = plan.cand_n.shape[0]
    R, CN, CK, A = dims

    init = _init_column(plan, dims, dtype)
    ap_init = init  # E = 0 at (n==0, allowed), rest -inf — same layout

    def step(carry, xs):
        fwd_prev, ap_prev, apE_final, fwdE_final = carry
        t, bwd_t = xs[0], xs[1]
        fxs = xs[2:]
        bwd_t = bwd_t.reshape(R, 5, CN, CK)
        cn = fxs[1].reshape(R, CN)
        allowed = fxs[2].reshape(R, CN, CK)
        row_same = fxs[10].reshape(R, CN)
        row_prev = fxs[11].reshape(R, CN)
        col_same = fxs[12].reshape(R, CK)
        col_prec = fxs[13].reshape(R, CK * A)  # flat: one batched gather

        fwd_t = _fwd_column(fwd_prev, fxs, trans_log, dims, kmer_size, dtype)
        fwd_t = jnp.where(t == 0, init, fwd_t)
        # two normalizers for fwd+bwd: the VITERBI accumulates the
        # global-Z form (per-t constants cancel in its argmax — every
        # path visits every t), while the
        # STORED lp the walk reads for the reported probabilities is
        # fp32-normalized by the COLUMN's own mass — equal to Z by the
        # forward-backward identity (up to the tiny overcount of same-t
        # I-chain revisits) but immune to the ~0.2-nat fp32 drift of Z
        # over 16k scan steps, which otherwise shifts EVERY reported
        # probability by the same exp(drift) factor. fp64 stores the
        # global-Z form (exactly the reference's normalizer,
        # NTC_main.cpp:186 — drift-free at f64 and bit-comparable).
        ap = fwd_t + bwd_t
        lp = ap - Z_norm[:, None, None, None]
        if jnp.dtype(dtype) == jnp.float64:
            lp_store = lp
        else:
            m = jnp.max(ap, axis=(1, 2, 3), keepdims=True)
            m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
            colZ = m_safe + jnp.log(
                jnp.sum(jnp.exp(ap - m_safe), axis=(1, 2, 3),
                        keepdims=True))
            lp_store = jnp.where(jnp.isfinite(m), ap - colZ, NEG_INF)

        # Viterbi max over posteriors + first-match choices
        ge_same = _gr(ap_prev, row_same)
        ge_prev = _gr(ap_prev, row_prev)

        # A: for pre in prec order: E then I (ref walk order); candidates
        # stack on axis 0 and one argmax encodes the first-match choice
        gprec = _gc(
            jnp.stack([ge_prev[:, E_ST], ge_prev[:, I_ST], ge_same[:, E_ST],
                       ge_same[:, S_ST], ge_same[:, I_ST]], axis=1),
            col_prec,
        )
        sl = lambda g, x, ai: g[:, x, :, ai * CK:(ai + 1) * CK]
        a_cands = [t for ai in range(A)
                   for t in (sl(gprec, 0, ai), sl(gprec, 1, ai))]
        a_max, ch_a = _first_match(a_cands, dtype)
        p_cands = [t for ai in range(A)
                   for t in (sl(gprec, 2, ai), sl(gprec, 3, ai),
                             sl(gprec, 4, ai))]
        p_max, ch_p = _first_match(p_cands, dtype)
        gsame = _gc(
            jnp.stack([ge_prev[:, E_ST], ge_prev[:, P_ST], ge_prev[:, I_ST],
                       ge_same[:, E_ST], ge_same[:, A_ST], ge_same[:, S_ST],
                       ge_same[:, P_ST]], axis=1),
            col_same,
        )
        s_max, ch_s = _first_match(
            [gsame[:, 0], gsame[:, 1], gsame[:, 2]], dtype
        )
        e_max, ch_e = _first_match(
            [gsame[:, 3], gsame[:, 4], gsame[:, 5], gsame[:, 6]], dtype
        )

        n_pos = (cn >= 1)[:, :, None]
        ok = allowed & n_pos
        a_new = jnp.where(ok, a_max + lp[:, A_ST], NEG_INF)
        p_new = jnp.where(ok, p_max + lp[:, P_ST], NEG_INF)
        s_new = jnp.where(ok, s_max + lp[:, S_ST], NEG_INF)
        e_new = jnp.where(ok, e_max + lp[:, E_ST], NEG_INF)

        # Viterbi I chain as a max-plus associative scan over n-slots
        e_above = jnp.concatenate(
            [jnp.full((R, 1, CK), NEG_INF, dtype), e_new[:, :-1]], axis=1
        )
        chain = jnp.concatenate(
            [jnp.zeros((R, 1), bool), cn[:, :-1] == cn[:, 1:] - 1], axis=1
        )
        cond = chain[:, :, None] & ok
        lpI = lp[:, I_ST]
        iA = jnp.where(cond, e_above + lpI, NEG_INF)
        iB = jnp.where(cond, lpI, NEG_INF)
        i_new, _ = jax.lax.associative_scan(_aff_max, (iA, iB), axis=1)
        i_prev = jnp.concatenate(
            [jnp.full((R, 1, CK), NEG_INF, dtype), i_new[:, :-1]], axis=1
        )
        # E overrides I on ties (ref: NTC.cpp:884-893 two plain ifs)
        ch_i = jnp.where(e_above >= i_prev, 0, 1).astype(jnp.int32)

        ap_out = jnp.stack([a_new, p_new, s_new, e_new, i_new], axis=1)
        ap_out = jnp.where(t == 0, ap_init, ap_out)
        packed = (
            ch_e | (ch_a << 2) | (ch_p << 5) | (ch_s << 9) | (ch_i << 11)
        ).astype(jnp.int32)
        packed = jnp.where(t == 0, 0, packed)
        is_term = (t == T_r - 1)[:, None, None]
        apE_final = jnp.where(is_term, ap_out[:, E_ST], apE_final)
        fwdE_final = jnp.where(is_term, fwd_t[:, E_ST], fwdE_final)
        return (
            (fwd_t, ap_out, apE_final, fwdE_final),
            (lp_store.reshape(R, -1), packed.reshape(R, -1)),  # store flat
        )

    apE0 = jnp.full((R, CN, CK), NEG_INF, dtype)
    xs = (
        jnp.arange(T_pad, dtype=jnp.int32), bwd,
    ) + _fwd_xs(plan, sig)
    (_, _, apE_final, fwdE_final), (lp, choices) = jax.lax.scan(
        step, (init, ap_init, apE0, apE0), xs
    )
    return lp, choices, apE_final, fwdE_final


def ntc_zf_batch(plan: NTCPlan, dims: PlanDims, finalE, N_r, T_r):
    """Zf from the forward terminal E column (ref: NTC_main.cpp:159-165),
    dead/duplicate slots excluded."""
    _, _, _, mask = _final_row_masks(plan, dims, N_r, T_r)
    return logsumexp(jnp.where(mask, finalE, NEG_INF), axis=(1, 2))


def ntc_zb_batch(plan: NTCPlan, dims: PlanDims, bwd0):
    """Zb over E at (t=0, n==0 slots) (ref: NTC_main.cpp:152-158)."""
    R, CN, CK, _ = dims
    row0 = (
        (plan.cand_n[0].reshape(R, CN) == 0)[:, :, None]
        & plan.allowed[0].reshape(R, CN, CK).astype(bool)
        & plan.live[0].reshape(R, CK)[:, None, :]
    )
    bwd0 = bwd0.reshape(R, 5, CN, CK)
    return logsumexp(jnp.where(row0, bwd0[:, E_ST], NEG_INF), axis=(1, 2))
