"""Pallas (Triton) kernels for the banded NT DP on the GPU.

Same recurrences as the scan path in ops/nt_banded_batch (ref:
src/cpp/NT_banded.cpp:23-123 forward/backward, 139-189 Viterbi, 204-250
traceback, 303-371 transition training), written for one GPU program per
read: the whole wavefront loop over t runs inside the program
(`fori_loop` up to the read's own T), with the (B,) band rows in
registers. Nothing carries between programs, so a bucket of R reads is a
grid of R independent programs.

The band shift (the band start moves by at most one position per row) is
a load at offset -1/0/+1 from the row just stored: every kernel keeps its
last rows in a small per-read buffer of width B+2 whose two guard cells
hold -inf, double-buffered by the parity of t, so one barrier per row
orders the stores before the next row's loads. The emission-parameter
windows are direct loads at the row's band start.

Kernels and the pipeline they form:
  * backward — bM/bE (R, T_pad, B) and Zb; with `fe`, it also folds the
    m1/e2 Baum-Welch numerators into per-lane sums (training);
  * forward — fM/fE and Zf (training);
  * fwd_vit — forward, posterior and Viterbi in one pass: the forward rows
    never leave the program, the log posteriors overwrite bM/bE in place,
    and the choice bits are stored as int8;
  * walk — the MAP traceback, one scalar step per row; it normalizes the
    posterior it reports by the row's total (nt_banded_batch.row_lse,
    computed by XLA between the two kernels: inside the fused pass the
    row reduction cost a synchronisation per row, +13 ms per 64×16k
    bucket on an H100).

`banded_segment` chains backward -> fwd_vit -> walk. Every kernel takes
`interpret` for CPU tests; production calls leave it False.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from dynamont_jax.ops import nt_banded_batch as bb

NEG_INF = float("-inf")
# 8 warps (256 threads, two band cells each at B = 512): 55 ms against
# 63 ms at 4 warps for the 64 x 16k segmentation bucket on an H100 (PERF.md)
NUM_WARPS = 8


def kernels_enabled(dtype) -> bool:
    """The path choice for the banded DP, made here only: the kernels on a
    GPU for float32 work, the XLA scans everywhere else (CPU, fp64)."""
    return jax.default_backend() == "gpu" and jnp.dtype(dtype) == jnp.float32


def _call(kernel, R: int, out_shape, interpret: bool, aliases=None):
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(R,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        input_output_aliases=aliases or {},
        interpret=interpret,
    )


def _lae(a, b):
    """jnp.logaddexp's formula, spelled out for the kernel body."""
    amax = jnp.maximum(a, b)
    delta = a - b
    return jnp.where(jnp.isnan(delta), a + b,
                     amax + jnp.log1p(jnp.exp(-jnp.abs(delta))))


def _valid(j, bs, bw, N, lower: int):
    """Band columns of row t holding n in [max(lower, bs), min(bs+2bw+1,
    N)) (see nt_banded_batch._valid_mask)."""
    ns = jnp.maximum(bs, lower)
    ne = jnp.minimum(bs + 2 * bw + 1, N)
    return (j >= ns - bs + 1) & (j < ne - bs + 1)


def _row(ref, r, slot, k, start, B):
    """Row k of the shift buffer, read at `start` (1 = unshifted, 0 = the
    band shifted right by one, 2 = shifted left by one)."""
    return ref[r, slot, k, pl.ds(start, B)]


def _put(ref, r, slot, k, val, B):
    ref[r, slot, k, pl.ds(1, B)] = val


def _barrier(interpret: bool):
    # the interpreter runs a program's rows in order; on the GPU the
    # threads of the program meet here before reading the row just stored
    if not interpret:
        plgpu.debug_barrier()


def _guards(ref, r, rows: int, B: int, interpret: bool):
    """-inf over every row of the shift buffer, guard cells included. The
    two overlapping stores and the first row stores that follow write the
    same cells from different threads: the barrier orders them."""
    neg = jnp.full((B,), NEG_INF, jnp.float32)
    for slot in range(2):
        for k in range(rows):
            ref[r, slot, k, pl.ds(0, B)] = neg
            ref[r, slot, k, pl.ds(2, B)] = neg
    _barrier(interpret)


def _scores(mu_ref, c1_ref, c2_ref, r, base, x, B):
    mu = mu_ref[r, pl.ds(base, B)]
    d = x - mu
    return c1_ref[r, pl.ds(base, B)] - c2_ref[r, pl.ds(base, B)] * d * d


def _at(row, idx, j):
    return jnp.sum(jnp.where(j == idx, row, 0.0))


def _scal(batch: bb.BandedBatch):
    return jnp.stack([batch.T, batch.N, batch.bw], axis=1).astype(jnp.int32)


def _inputs(batch: bb.BandedBatch, log_m1, log_e2):
    f32 = lambda a: a.astype(jnp.float32)
    trans = jnp.stack([jnp.asarray(log_m1, jnp.float32),
                       jnp.asarray(log_e2, jnp.float32)])
    return (_scal(batch), trans, f32(batch.sig), f32(batch.mu_pad),
            f32(batch.c1_pad), f32(batch.c2_pad),
            batch.bstart.astype(jnp.int32))


def _shift_buf(R, rows, B):
    return jax.ShapeDtypeStruct((R, 2, rows, B + 2), jnp.float32)


# ---------------------------------------------------------------------------
# backward (+ transition numerators)
# ---------------------------------------------------------------------------

def _bwd_kernel(*refs, B, pad, train, interpret):
    if train:
        (scal_ref, trans_ref, sig_ref, mu_ref, c1_ref, c2_ref, bs_ref,
         fe_ref, zf_ref, M_out, E_out, zb_out, acc_out, shf) = refs
    else:
        (scal_ref, trans_ref, sig_ref, mu_ref, c1_ref, c2_ref, bs_ref,
         M_out, E_out, zb_out, shf) = refs
    r = pl.program_id(0)
    T, N, bw = scal_ref[r, 0], scal_ref[r, 1], scal_ref[r, 2]
    lm1, le2 = trans_ref[0], trans_ref[1]
    j = jnp.arange(B, dtype=jnp.int32)
    neg = jnp.full((B,), NEG_INF, jnp.float32)
    term = jnp.where(j == bw + 1, 0.0, NEG_INF).astype(jnp.float32)

    def pad_rows(t, c):
        M_out[r, t, :] = neg
        E_out[r, t, :] = neg
        return c

    jax.lax.fori_loop(T, M_out.shape[1], pad_rows, 0)
    _guards(shf, r, 2, B, interpret)
    # the terminal row t = T-1 (ref: E = 0 at the band center)
    M_out[r, T - 1, :] = neg
    E_out[r, T - 1, :] = term
    _put(shf, r, (T - 1) & 1, 0, neg, B)
    _put(shf, r, (T - 1) & 1, 1, term, B)
    _barrier(interpret)
    if train:
        zf = zf_ref[r]
        # numerators are summed as exp(term - Zf): Zf cancels in the
        # m1/e2 normalization and keeps every summand near [0, 1]
        zref = jnp.where(jnp.isfinite(zf), zf, 0.0)
        bs_first = bs_ref[r, 0]
        bs_quirk = bs_ref[r, jnp.maximum(T - 2, 0)]

    def body(i, carry):
        t = T - 2 - i
        bs = bs_ref[r, t]
        s1 = (bs_ref[r, t + 1] != bs).astype(jnp.int32)
        x = sig_ref[r, t]
        base = bs - 2 + pad
        sc_b = _scores(mu_ref, c1_ref, c2_ref, r, base, x, B)
        sc_a = _scores(mu_ref, c1_ref, c2_ref, r, base + 1, x, B)
        slot = (t + 1) & 1
        E_n = _row(shf, r, slot, 1, 1 - s1, B)
        M_n = _row(shf, r, slot, 0, 2 - s1, B)
        n = bs + j - 1
        ext = jnp.where(n + 1 < N, M_n + sc_a + lm1, NEG_INF)
        has_prev = n > 0
        M_new = jnp.where(has_prev, E_n + sc_b, NEG_INF)
        ext = jnp.where(has_prev, _lae(ext, E_n + sc_b + le2), ext)
        valid = _valid(j, bs, bw, N, 0)
        M_new = jnp.where(valid, M_new, NEG_INF)
        E_new = jnp.where(valid, ext, NEG_INF)
        M_out[r, t, :] = M_new
        E_out[r, t, :] = E_new
        if train:
            acc_m1, acc_e2 = carry[1], carry[2]
            # the reference's shift tracker compares row T-2 against row 0
            # (ref: NT_banded.cpp:309); only the numerators see it
            snq = jnp.where(t == T - 2, (bs_quirk != bs_first).astype(
                jnp.int32), s1)
            bMq = _row(shf, r, slot, 0, 2 - snq, B)
            bEq = _row(shf, r, slot, 1, 1 - snq, B)
            fE = fe_ref[r, t, :]
            m1_t = jnp.where(n + 1 < N, fE + lm1 + sc_a + bMq - zref,
                             NEG_INF)
            e2_t = jnp.where(n > 0, fE + le2 + sc_b + bEq - zref, NEG_INF)
            carry = (E_new, acc_m1 + jnp.exp(m1_t), acc_e2 + jnp.exp(e2_t))
        else:
            carry = (E_new,)
        _put(shf, r, t & 1, 0, M_new, B)
        _put(shf, r, t & 1, 1, E_new, B)
        _barrier(interpret)
        return carry

    zeros = jnp.zeros((B,), jnp.float32)
    init = (term, zeros, zeros) if train else (term,)
    out = jax.lax.fori_loop(0, T - 1, body, init)
    zb_out[r] = _at(out[0], bw + 1, j)
    if train:
        acc_out[r, 0] = jnp.sum(out[1])
        acc_out[r, 1] = jnp.sum(out[2])


def backward(batch: bb.BandedBatch, log_m1, log_e2, interpret: bool = False,
             fe=None, zf=None):
    """Backward DP: (bM, bE, Zb), bM/bE (R, T_pad, B), rows past each
    read's T at -inf. With the forward E store `fe` and `zf`, also returns
    the per-read (R, 2) sums of exp(numerator - Zf) of m1 and e2."""
    R, Tm1 = batch.sig.shape
    T_pad, B = Tm1 + 1, batch.B
    train = fe is not None
    args = _inputs(batch, log_m1, log_e2)
    mat = jax.ShapeDtypeStruct((R, T_pad, B), jnp.float32)
    vec = jax.ShapeDtypeStruct((R,), jnp.float32)
    outs = [mat, mat, vec]
    if train:
        args += (fe.astype(jnp.float32), zf.astype(jnp.float32))
        outs.append(jax.ShapeDtypeStruct((R, 2), jnp.float32))
    outs.append(_shift_buf(R, 2, B))
    kernel = functools.partial(_bwd_kernel, B=B, pad=batch.pad, train=train,
                               interpret=interpret)
    res = _call(kernel, R, tuple(outs), interpret)(*args)
    return res[:-1]


# ---------------------------------------------------------------------------
# forward, and forward + posterior + Viterbi
# ---------------------------------------------------------------------------

def _fwd_kernel(*refs, B, pad, viterbi, interpret):
    if viterbi:
        (scal_ref, trans_ref, sig_ref, mu_ref, c1_ref, c2_ref, bs_ref,
         zb_ref, bm_ref, be_ref, pm_out, pe_out, ch_out, zf_out,
         shf) = refs
    else:
        (scal_ref, trans_ref, sig_ref, mu_ref, c1_ref, c2_ref, bs_ref,
         M_out, E_out, zf_out, shf) = refs
    r = pl.program_id(0)
    T, N, bw = scal_ref[r, 0], scal_ref[r, 1], scal_ref[r, 2]
    lm1, le2 = trans_ref[0], trans_ref[1]
    j = jnp.arange(B, dtype=jnp.int32)
    neg = jnp.full((B,), NEG_INF, jnp.float32)
    init = jnp.where(j == bw + 1, 0.0, NEG_INF).astype(jnp.float32)
    rows = 4 if viterbi else 2
    _guards(shf, r, rows, B, interpret)
    for k in range(rows):
        _put(shf, r, 0, k, init if k % 2 else neg, B)
    if viterbi:
        zb = zb_ref[r]
        pm_out[r, 0, :] = neg + bm_ref[r, 0, :] - zb
        pe_out[r, 0, :] = init + be_ref[r, 0, :] - zb
        ch_out[r, 0, :] = jnp.zeros((B,), jnp.int8)
    else:
        M_out[r, 0, :] = neg
        E_out[r, 0, :] = init
    _barrier(interpret)

    def body(t, E_last):
        bs = bs_ref[r, t]
        s1 = (bs != bs_ref[r, t - 1]).astype(jnp.int32)
        x = sig_ref[r, t - 1]
        sc_b = _scores(mu_ref, c1_ref, c2_ref, r, bs - 2 + pad, x, B)
        slot = (t - 1) & 1
        E_m = _row(shf, r, slot, 1, s1, B)
        M_e = _row(shf, r, slot, 0, 1 + s1, B)
        E_e = _row(shf, r, slot, 1, 1 + s1, B)
        valid = _valid(j, bs, bw, N, 1)
        M_new = jnp.where(valid, E_m + sc_b + lm1, NEG_INF)
        E_new = jnp.where(valid, _lae(M_e + sc_b, E_e + sc_b + le2),
                          NEG_INF)
        if viterbi:
            lpm = M_new + bm_ref[r, t, :] - zb
            lpe = E_new + be_ref[r, t, :] - zb
            pm_out[r, t, :] = lpm
            pe_out[r, t, :] = lpe
            vE_m = _row(shf, r, slot, 3, s1, B)
            vM_e = _row(shf, r, slot, 2, 1 + s1, B)
            vE_e = _row(shf, r, slot, 3, 1 + s1, B)
            vM_new = jnp.where(valid, vE_m + lpm, NEG_INF)
            vE_new = jnp.where(valid, jnp.maximum(vM_e, vE_e) + lpe,
                               NEG_INF)
            ch_out[r, t, :] = (vE_new == vM_e + lpe).astype(jnp.int8)
            _put(shf, r, t & 1, 2, vM_new, B)
            _put(shf, r, t & 1, 3, vE_new, B)
        else:
            M_out[r, t, :] = M_new
            E_out[r, t, :] = E_new
        _put(shf, r, t & 1, 0, M_new, B)
        _put(shf, r, t & 1, 1, E_new, B)
        _barrier(interpret)
        return E_new

    E_last = jax.lax.fori_loop(1, T, body, init)
    zf_out[r] = _at(E_last, bw + 1, j)
    if not viterbi:
        def pad_rows(t, c):
            M_out[r, t, :] = neg
            E_out[r, t, :] = neg
            return c

        jax.lax.fori_loop(T, M_out.shape[1], pad_rows, 0)


def forward(batch: bb.BandedBatch, log_m1, log_e2, interpret: bool = False):
    """Forward DP: (fM, fE, Zf), fM/fE (R, T_pad, B), rows past each
    read's T at -inf."""
    R, Tm1 = batch.sig.shape
    T_pad, B = Tm1 + 1, batch.B
    mat = jax.ShapeDtypeStruct((R, T_pad, B), jnp.float32)
    kernel = functools.partial(_fwd_kernel, B=B, pad=batch.pad,
                               viterbi=False, interpret=interpret)
    M, E, zf, _ = _call(
        kernel, R,
        (mat, mat, jax.ShapeDtypeStruct((R,), jnp.float32),
         _shift_buf(R, 2, B)),
        interpret,
    )(*_inputs(batch, log_m1, log_e2))
    return M, E, zf


def fwd_vit(batch: bb.BandedBatch, bM, bE, Zb, log_m1, log_e2,
            interpret: bool = False):
    """Forward + posterior + Viterbi in one pass over the backward store:
    returns (LPM, LPE, choices, Zf). LPM/LPE are the log posteriors
    for + back - Zb and take over bM/bE's buffers; choices (R, T_pad, B)
    int8 is the traceback bit E[t,j] == M[t-1,j+s] + LPE[t,j]. Rows past
    each read's T keep bM/bE's -inf."""
    R, Tm1 = batch.sig.shape
    T_pad, B = Tm1 + 1, batch.B
    mat = jax.ShapeDtypeStruct((R, T_pad, B), jnp.float32)
    kernel = functools.partial(_fwd_kernel, B=B, pad=batch.pad,
                               viterbi=True, interpret=interpret)
    args = _inputs(batch, log_m1, log_e2) + (
        Zb.astype(jnp.float32), bM.astype(jnp.float32),
        bE.astype(jnp.float32))
    LPM, LPE, ch, zf, _ = _call(
        kernel, R,
        (mat, mat, jax.ShapeDtypeStruct((R, T_pad, B), jnp.int8),
         jax.ShapeDtypeStruct((R,), jnp.float32), _shift_buf(R, 4, B)),
        interpret,
        aliases={8: 0, 9: 1},
    )(*args)
    return LPM, LPE, ch, zf


# ---------------------------------------------------------------------------
# traceback walk
# ---------------------------------------------------------------------------

def _walk_kernel(scal_ref, bs_ref, lpm_ref, lpe_ref, lse_ref, ch_ref,
                 path_out, prob_out, close_out):
    """MAP walk from (N-1, bw+1) at t = T-1 down to t = 1 (ref:
    NT_banded.cpp:204-250). Row t records the base the walk is in (-1
    once it has left base 1), its posterior (normalized by the row's log
    total lse), and whether the base closes there."""
    r = pl.program_id(0)
    T, N, bw = scal_ref[r, 0], scal_ref[r, 1], scal_ref[r, 2]

    def body(i, carry):
        n, jj, is_m = carry
        t = T - 1 - i
        active = n >= 1
        s = (bs_ref[r, t] != bs_ref[r, t - 1]).astype(jnp.int32)
        lp = jnp.where(is_m, lpm_ref[r, t, jj], lpe_ref[r, t, jj])
        p = jnp.exp(jnp.minimum(lp - lse_ref[r, t], 0.0))
        close = active & is_m
        path_out[r, t] = jnp.where(active, n, -1)
        prob_out[r, t] = jnp.where(jnp.isnan(p), 0.0, p)
        close_out[r, t] = close.astype(jnp.int8)
        ch = ch_ref[r, t, jj] != 0
        n_next = jnp.where(close, n - 1, n)
        j_next = jnp.where(close, jj - 1 + s, jnp.where(active, jj + s, jj))
        m_next = jnp.where(close, False, jnp.where(active, ch, is_m))
        return n_next, j_next, m_next

    jax.lax.fori_loop(0, T - 1, body, (N - 1, bw + 1, False))


def walk(LPM, LPE, choices, batch: bb.BandedBatch, N_max: int,
         interpret: bool = False, lse=None):
    """Traceback walk + grouped medians from read-major log posteriors:
    (starts (R, N_max), medians (R, N_max)), the outputs of
    nt_banded_device._walk_single. `lse` (R, T_pad) is each row's log
    total the reported posteriors are divided by (none: 0)."""
    from dynamont_jax.ops.nt_banded_device import walk_summaries

    R, T_pad, B = LPM.shape
    if lse is None:
        lse = jnp.zeros((R, T_pad), jnp.float32)
    vec = lambda dt: jax.ShapeDtypeStruct((R, T_pad), dt)
    path, prob, close = _call(
        _walk_kernel, R, (vec(jnp.int32), vec(jnp.float32), vec(jnp.int8)),
        interpret,
    )(_scal(batch), batch.bstart.astype(jnp.int32),
      LPM.astype(jnp.float32), LPE.astype(jnp.float32),
      lse.astype(jnp.float32), choices.astype(jnp.int8))
    t = jnp.arange(T_pad, dtype=jnp.int32)[None, :]
    # the kernel writes rows 1..T-1 only
    live = (t >= 1) & (t < batch.T[:, None])
    path = jnp.where(live & (path >= 0), path, N_max)
    close = live & (close != 0)
    fn = jax.vmap(lambda pn, pp, cl: walk_summaries(
        pn[1:], pp[1:], cl[1:], t[0, 1:] - 1, N_max))
    return fn(path, prob, close)


def banded_segment(batch: bb.BandedBatch, N_max: int, log_m1, log_e2,
                   interpret: bool = False):
    """The basic-mode pipeline on the kernels: backward -> fused forward +
    posterior + Viterbi -> row totals (XLA) -> walk. Returns (Zf, Zb,
    starts, medians)."""
    bM, bE, Zb = backward(batch, log_m1, log_e2, interpret)
    LPM, LPE, ch, Zf = fwd_vit(batch, bM, bE, Zb, log_m1, log_e2, interpret)
    lse = bb.row_lse(LPM, LPE)[..., 0]
    starts, medians = walk(LPM, LPE, ch, batch, N_max, interpret, lse)
    return Zf, Zb, starts, medians
