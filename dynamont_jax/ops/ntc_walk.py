"""On-device 5-state NTC traceback over precomputed choice bits.

The reference walks the sparse APSEI lattice on the host with equality
checks against the stored max-DP values (ref: src/cpp/NTC.cpp:691-904).
Shipping those tensors off-device is impossible at production sizes, so the
batched path stores, per cell, the *choice* — the first predecessor in the
reference's exact check order that attains the max (computed during the
Viterbi scan, ops/ntc_batch.ntc_posterior_viterbi_batch) — and this module
replays the walk as a reverse `lax.scan` over t:

* per column, at most CN in-column I-steps (the I state moves n-1 -> n
  within the same t, ref: NTC.cpp:884-893) followed by exactly one
  t-decrementing step run as a short unrolled micro-op loop;
* segment emissions and per-step posterior probabilities are written as
  tagged records; a grouped-median sort pass (same pattern as the banded
  walk, ops/nt_banded_device._walk_single) turns them into per-segment
  summaries;
* only (S_max, 6)-shaped summaries per read ever leave the device.

State legend (ref: NTC.cpp:699-703): A(lign) P(olish) S(equence) E(xtend)
I(nsert); A/P close segments ("M"/"P" rows with the polish k-mer), the
boundary break cases mirror NTC.cpp:714-770.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dynamont_jax.ops.ntc_batch import (
    A_ST, E_ST, I_ST, P_ST, S_ST, _final_row_masks,
)

NEG_INF = -jnp.inf


def start_slots(plan, dims, apE_final, N_r, T_r):
    """Initial walk cell: the last (ascending-k) live slot attaining the
    max of APSEI[T-1, N-1, :, E] (ref '>=' update over k ascending,
    NTC.cpp:656-664). Returns (i0, j0, k0, valid) each (R,)."""
    cand_last, _, _, mask = _final_row_masks(plan, dims, N_r, T_r)
    R, CN, CK = mask.shape
    v = jnp.where(mask, apE_final, NEG_INF).reshape(R, CN * CK)
    am_rev = jnp.argmax(v[:, ::-1], axis=1)
    flat = CN * CK - 1 - am_rev
    i0 = (flat // CK).astype(jnp.int32)
    j0 = (flat % CK).astype(jnp.int32)
    best = jnp.take_along_axis(v, flat[:, None], axis=1)[:, 0]
    valid = jnp.isfinite(best)
    idx = jnp.repeat(T_r - 1, CK)[None, :]
    ks_last = jnp.take_along_axis(plan.ks, idx, axis=0)[0].reshape(R, CK)
    k0 = jnp.take_along_axis(ks_last, j0[:, None], axis=1)[:, 0]
    return i0, j0, k0, valid


def ntc_walk_batch(plan, dims, lp, choices, N_r, T_r, i0, j0, k0,
                   valid_start, K: int, kmer_size: int, S_max: int,
                   max_i_chain: int = 2):
    """Replay the traceback for a whole bucket on device.

    lp/choices: flat (T, R, 5*CN*CK) / (T, R, CN*CK) from the Viterbi scan.
    Per column the walk does up to `max_i_chain` in-column I-steps before
    the t-step (an I-chain can theoretically span CN-1 slots but insertion
    runs longer than 2 are vanishingly rare); a longer chain sets the
    returned `stuck` flag and the engine re-runs that read exactly.
    Returns (seg_cnt (R,), state (R,S_max) int32 0=M 1=P, basepos, start,
    polish_k (R,S_max) int32, median (R,S_max), seg_overflow (R,) bool,
    stuck (R,) bool).
    """
    T_pad = plan.cand_n.shape[0]
    R, CN, CK, A = dims
    Kdiv = K // A
    half = kmer_size // 2
    NCK = CN * CK
    n_micro = min(CN - 1, max_i_chain) + 1

    def step(carry, xs):
        active, state, i, j, k, n, seg, stuck = carry
        lp_flat, ch_flat, rs_t, rp_t, cs_t, cp_flat, t = xs
        lp_flat = lp_flat.reshape(R, 5 * NCK)
        ch_flat = ch_flat.reshape(R, NCK)
        rs_t = rs_t.reshape(R, CN)
        rp_t = rp_t.reshape(R, CN)
        cs_t = cs_t.reshape(R, CK)
        cp_flat = cp_flat.reshape(R, CK * A)
        act_now = (t == T_r - 1) & valid_start
        active = active | act_now
        state = jnp.where(act_now, E_ST, state)
        i = jnp.where(act_now, i0, i)
        j = jnp.where(act_now, j0, j)
        k = jnp.where(act_now, k0, k)
        n = jnp.where(act_now, N_r - 1, n)
        seg = jnp.where(act_now, 0, seg)
        t1 = t == 1

        recs = []
        did_t = jnp.zeros((R,), bool)
        for _ in range(n_micro):
            cell = i * CK + j
            ch = jnp.take_along_axis(ch_flat, cell[:, None], axis=1)[:, 0]
            lp_state = jnp.take_along_axis(
                lp_flat, (state * NCK + cell)[:, None], axis=1
            )[:, 0]

            t_pos = t >= 1  # reference `while t:` exits at t == 0
            is_I = active & (state == I_ST) & t_pos
            i_break = is_I & (n == 1)
            i_go = is_I & ~i_break
            tstep = active & (state != I_ST) & (~did_t) & t_pos
            is_A = state == A_ST
            is_P = state == P_ST
            is_S = state == S_ST
            is_E = state == E_ST
            brk = tstep & t1 & (
                is_E | is_P | ((is_A | is_S) & (n == 1))
            )
            go = tstep & ~brk
            emit_break = brk & (is_E | is_A | is_P)   # S break: no emit
            emit_go = go & (is_A | is_P)
            emit = emit_break | emit_go

            prob = jnp.where(i_go | go, jnp.exp(lp_state), 0.0)
            p_seg = jnp.where(i_go | go, seg, S_max)
            e_state = jnp.where(is_P, 1, 0)
            e_bp = jnp.where(emit_break, half, n - 1 + half)
            e_start = jnp.where(emit_break, 0, t - 1)
            e_seg = jnp.where(emit, seg, S_max)
            recs.append((prob, p_seg, emit.astype(jnp.int32), e_state,
                         e_bp, e_start, k, e_seg))

            # choice decode (packing: ops/ntc_batch.ntc_posterior_viterbi_batch)
            chE = ch & 3
            chA = (ch >> 2) & 7
            chP = (ch >> 5) & 15
            chS = (ch >> 9) & 3
            chI = (ch >> 11) & 1
            rs = jnp.take_along_axis(rs_t, i[:, None], axis=1)[:, 0]
            rp = jnp.take_along_axis(rp_t, i[:, None], axis=1)[:, 0]
            cs = jnp.take_along_axis(cs_t, j[:, None], axis=1)[:, 0]
            ai = jnp.where(is_A, chA >> 1, chP // 3)
            # col_prec is A-MAJOR flat (see ntc_batch._build_plan_one)
            cpa = jnp.take_along_axis(
                cp_flat, (ai * CK + j)[:, None], axis=1
            )[:, 0]
            stE = jnp.where(
                chE == 0, E_ST,
                jnp.where(chE == 1, A_ST, jnp.where(chE == 2, S_ST, P_ST)),
            )
            stA = jnp.where((chA & 1) == 0, E_ST, I_ST)
            m3 = chP - ai * 3
            stP = jnp.where(m3 == 0, E_ST, jnp.where(m3 == 1, S_ST, I_ST))
            stS = jnp.where(chS == 0, E_ST, jnp.where(chS == 1, P_ST, I_ST))
            stI = jnp.where(chI == 0, E_ST, I_ST)
            k_prec = k // A + ai * Kdiv

            st_go = jnp.where(
                is_E, stE, jnp.where(is_A, stA, jnp.where(is_P, stP, stS))
            )
            i_go_slot = jnp.where(is_E | is_P, rs, rp)
            j_go_slot = jnp.where(is_E | is_S, cs, cpa)
            k_go = jnp.where(is_A | is_P, k_prec, k)
            n_go = jnp.where(is_A | is_S, n - 1, n)

            state = jnp.where(i_go, stI, jnp.where(go, st_go, state))
            i = jnp.clip(
                jnp.where(i_go, i - 1, jnp.where(go, i_go_slot, i)), 0, CN - 1
            )
            j = jnp.clip(jnp.where(go, j_go_slot, j), 0, CK - 1)
            k = jnp.where(go, k_go, k)
            n = jnp.where(i_go, n - 1, jnp.where(go, n_go, n))
            seg = seg + emit.astype(jnp.int32)
            active = active & ~(i_break | brk)
            did_t = did_t | go | brk

        # an I-chain longer than n_micro-1 exhausted the micro-ops without
        # reaching the column's t-step -> this read's walk is invalid
        stuck = stuck | (active & ~did_t & (t >= 1))
        out = tuple(
            jnp.stack([r[f] for r in recs], axis=0) for f in range(8)
        )
        return (active, state, i, j, k, n, seg, stuck), out

    z_i = jnp.zeros((R,), jnp.int32)
    init = (jnp.zeros((R,), bool), z_i, z_i, z_i, z_i, z_i, z_i,
            jnp.zeros((R,), bool))
    # full-range flat xs: slicing/reshaping the stored tensors would copy them
    xs = (
        lp, choices,
        plan.row_same, plan.row_prev, plan.col_same,
        plan.col_prec, jnp.arange(T_pad, dtype=jnp.int32),
    )
    (_, _, _, _, _, _, seg_cnt, stuck), outs = jax.lax.scan(
        step, init, xs, reverse=True
    )
    probs, p_seg, emit, e_state, e_bp, e_start, e_k, e_seg = (
        jnp.moveaxis(o, 2, 0).reshape(R, -1) for o in outs
    )
    st_a, bp_a, start_a, k_a, med = jax.vmap(
        lambda *r: finish_records(*r, S_max=S_max)
    )(probs, p_seg, e_state, e_bp, e_start, e_k, e_seg)
    return seg_cnt, st_a, bp_a, start_a, k_a, med, (seg_cnt > S_max) | stuck


def finish_records(probs, p_seg, e_state, e_bp, e_start, e_k, e_seg, *,
                   S_max: int):
    """Per-read segment summaries from tagged walk records (1D arrays).

    Emission records (one per segment, tagged e_seg; S_max = none) carry
    state/basepos/start/polish-k; probability records (tagged p_seg) are
    grouped and reduced to the segment's median via one 2-key sort
    (ref computes the same median on the host, NTC.cpp:718-723)."""
    M = probs.shape[0]
    sc = lambda vals: jnp.zeros((S_max + 1,), vals.dtype).at[e_seg].set(
        vals, mode="drop"
    )[:S_max]
    st_a = sc(e_state)
    bp_a = sc(e_bp)
    start_a = sc(e_start)
    k_a = sc(e_k)
    pv = jnp.where(p_seg < S_max, probs, jnp.inf)
    sk, sp = jax.lax.sort((p_seg, pv), num_keys=2)
    counts = jnp.zeros((S_max + 1,), jnp.int32).at[p_seg].add(
        1, mode="drop"
    )[:S_max]
    offsets = jnp.cumsum(counts) - counts
    lo = jnp.clip(offsets + (counts - 1) // 2, 0, M - 1)
    hi = jnp.clip(offsets + counts // 2, 0, M - 1)
    med = 0.5 * (sp[lo] + sp[hi])
    med = jnp.where(counts > 0, med, 0.0)
    return st_a, bp_a, start_a, k_a, med
