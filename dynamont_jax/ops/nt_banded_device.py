"""Fully device-resident banded segmentation: compact wire format in,
segment summaries out.

Motivation: the DP tensors (posteriors + choice bits) are hundreds of MB per
batch, far more than the summaries the host needs, so nothing bulky crosses
the host<->device link. This module keeps the whole read pipeline on
device:

    int16 raw samples --> affine normalize --> Hampel(3) --> banded
    forward/backward --> posteriors --> Viterbi --> traceback walk -->
    per-base (start, median posterior)

and transfers only:
    H2D: raw int16 samples, per-position k-mer ids, bit-packed band shifts,
         per-read scalars            (~2.3 bytes/sample)
    D2H: per-base segment starts + medians + Z values (~8 bytes/base)

The sequential MAP walk (ref: NT_banded.cpp:204-250) runs as a lax.scan over
t — one carry update per signal sample — and the per-segment medians of the
reference (ref: utils.cpp:443-467 calculateMedian) become one lexicographic
sort of (base, prob) pairs + grouped middle-element gathers, since the walk
visits bases in monotone order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dynamont_jax.ops import nt_banded_batch as bb
from dynamont_jax.ops.geometry import band_geometry, effective_bandwidth

NEG_INF = -jnp.inf


class WireBatch(NamedTuple):
    """Minimal host->device payload for a padded batch of reads."""

    dacs: jax.Array        # (R, T_pad-1) int16 raw/quantized samples
    aff_a: jax.Array       # (R,) float32: sig = dacs * a + b
    aff_b: jax.Array       # (R,)
    kmer_ids: jax.Array    # (R, N_max-1) int32, 0-padded
    shift_bits: jax.Array  # (R, ceil(T_pad/8)) uint8, little-endian bits of
                           # shift[t] = (bstart[t] != bstart[t-1])
    T: jax.Array           # (R,) int32 true T
    N: jax.Array           # (R,) int32 true N
    bw: jax.Array          # (R,) int32 effective bandwidth
    pad: int               # static left padding of position arrays
    B: int                 # static band width
    N_max: int             # static max N in bucket
    T_pad: int             # static padded T


class DeviceSegResult(NamedTuple):
    Zf: jax.Array       # (R,)
    Zb: jax.Array       # (R,)
    starts: jax.Array   # (R, N_max) int32 segment start per base, -1 = none
    medians: jax.Array  # (R, N_max) median posterior prob per base


def quantize_signal(sig: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Lossy-but-tiny (<=1e-4 absolute) int16 encoding of an already
    normalized float signal. Real pipelines pass raw ONT int16 DACs with the
    pod5 calibration+normalization affine instead — losslessly."""
    m = float(np.max(np.abs(sig))) if len(sig) else 1.0
    # snapped to float32 because that is the wire dtype of the affine —
    # keeps host-side reconstruction bit-identical to the device's
    a = float(np.float32(max(m, 1e-12) / 32000.0))
    dac = np.clip(np.rint(sig / a), -32768, 32767).astype(np.int16)
    return dac, a, 0.0


def prepare_wire(
    signals: list[np.ndarray] | None,
    kmer_ids_list: list[np.ndarray],
    band: int = 400,
    t_pad_to: int = 512,
    dacs: list[np.ndarray] | None = None,
    affines: list[tuple[float, float]] | None = None,
    device=None,
    t_pad: int | None = None,
    n_pad_to: int = 1,
) -> WireBatch:
    """Pack reads into the wire format. Pass either float `signals` (they are
    int16-quantized here) or raw `dacs` + per-read `affines` (a, b).

    `device` places the wire arrays on a specific local device (one H2D
    straight to the target; the engine round-robins buckets across
    `jax.local_devices()`). None keeps the default-device behavior.
    `t_pad` overrides the padded length (engines pass ladder points so
    shapes dedupe); `n_pad_to` quantizes N_max the same way — both are
    static jit shapes, and every distinct value is a fresh compile."""
    if dacs is None:
        assert signals is not None
        enc = [quantize_signal(s) for s in signals]
        dacs = [e[0] for e in enc]
        affines = [(e[1], e[2]) for e in enc]
    R = len(dacs)
    T_arr = np.array([len(d) + 1 for d in dacs], dtype=np.int32)
    N_arr = np.array([len(k) + 1 for k in kmer_ids_list], dtype=np.int32)
    bw_arr = np.array([effective_bandwidth(band, int(n)) for n in N_arr], np.int32)
    max_bw = int(bw_arr.max())
    B = bb.band_width(max_bw)
    pad = max_bw + 3
    T_pad = t_pad if t_pad is not None else bb.round_up(int(T_arr.max()), t_pad_to)
    assert T_pad >= int(T_arr.max())
    N_max = bb.round_up(int(N_arr.max()), n_pad_to)
    n_bytes = (T_pad + 7) // 8

    dac_arr = np.zeros((R, T_pad - 1), dtype=np.int16)
    kid_arr = np.zeros((R, N_max - 1), dtype=np.int32)
    bits = np.zeros((R, n_bytes), dtype=np.uint8)
    a_arr = np.zeros(R, np.float32)
    b_arr = np.zeros(R, np.float32)
    for i in range(R):
        T, N, bw = int(T_arr[i]), int(N_arr[i]), int(bw_arr[i])
        dac_arr[i, : T - 1] = dacs[i]
        kid_arr[i, : N - 1] = kmer_ids_list[i]
        a_arr[i], b_arr[i] = affines[i]
        geom = band_geometry(T, N, bw)  # float64 midpoint parity on host
        shift = np.zeros(T_pad, dtype=np.uint8)
        shift[1:T] = geom.shift[1:].astype(np.uint8)
        bits[i] = np.packbits(shift, bitorder="little")
    put = (lambda x: jax.device_put(x, device)) if device is not None \
        else jnp.asarray
    return WireBatch(
        dacs=put(dac_arr), aff_a=put(a_arr),
        aff_b=put(b_arr), kmer_ids=put(kid_arr),
        shift_bits=put(bits), T=put(T_arr),
        N=put(N_arr), bw=put(bw_arr),
        pad=pad, B=B, N_max=N_max, T_pad=T_pad,
    )


# ---------------------------------------------------------------------------
# device-side preprocessing
# ---------------------------------------------------------------------------

def _median3(a, b, c):
    return jnp.maximum(jnp.minimum(a, b), jnp.minimum(jnp.maximum(a, b), c))


def hampel3_device(sig, L, n_sigmas=3.0):
    """Window-3 Hampel filter, reference semantics (ref: FileIO.py:17-43):
    positions i in [1, L-3] compare against the median of original[i-1..i+1];
    outliers are replaced by that median. L is the true (traced) length."""
    k = 1.4826
    left = jnp.concatenate([sig[:1], sig[:-1]])
    right = jnp.concatenate([sig[1:], sig[-1:]])
    med = _median3(left, sig, right)
    mad = k * _median3(jnp.abs(left - med), jnp.abs(sig - med), jnp.abs(right - med))
    i = jnp.arange(sig.shape[0])
    in_range = (i >= 1) & (i < L - 2)
    outlier = in_range & (jnp.abs(sig - med) > n_sigmas * mad)
    return jnp.where(outlier, med, sig)


def _unpack_shift_bits(bits, T_pad):
    """(n_bytes,) uint8 -> (T_pad,) int32 of 0/1 shift flags."""
    b = bits[:, None] >> jnp.arange(8, dtype=jnp.uint8)[None, :]
    return (b & 1).astype(jnp.int32).reshape(-1)[:T_pad]


def _cumsum_1d(x):
    """Inclusive cumsum of a (T,) 0/1 vector."""
    return jnp.cumsum(x)


def _decode_single(wire: WireBatch, means_t, c1_t, c2_t, dtype, hampel: bool):
    """Per-read device decode: wire fields -> (sig, mu_pad, c1_pad, c2_pad,
    bstart) in the layout the scan kernels expect."""

    def fn(dac, a, b_off, kid, bits, T, N, bw):
        sig = dac.astype(dtype) * a.astype(dtype) + b_off.astype(dtype)
        if hampel:
            sig = hampel3_device(sig, T - 1)
        shift = _unpack_shift_bits(bits, wire.T_pad)
        bstart = _cumsum_1d(shift) - bw
        pos_live = jnp.arange(wire.N_max - 1) < N - 1
        kid = jnp.where(pos_live, kid, 0)
        mu = jnp.where(pos_live, means_t[kid], 0.0)
        c1 = jnp.where(pos_live, c1_t[kid], 0.0)
        c2 = jnp.where(pos_live, c2_t[kid], 0.0)
        padv = lambda x: jnp.pad(x, (wire.pad, wire.pad + wire.B))
        return sig, padv(mu), padv(c1), padv(c2), bstart.astype(jnp.int32)

    return fn


# ---------------------------------------------------------------------------
# device-side MAP walk + grouped medians
# ---------------------------------------------------------------------------

def walk_summaries(path_n, probs, closes, starts_t, N_max: int):
    """Per-base segment starts and median posteriors of one read's walk.

    path_n/probs/closes/starts_t are per visited row: the base the walk is
    in (N_max when inactive), its posterior, whether the base closes there,
    and the segment start that row stands for. Each base closes at most
    once; the path visits bases in monotone order, so the medians are one
    sort of (base, prob) and grouped middle-element gathers."""
    dtype = probs.dtype
    starts = jnp.full((N_max + 1,), -1, jnp.int32)
    idx = jnp.where(closes, path_n, N_max)
    starts = starts.at[idx].set(starts_t)[:N_max]
    keys = path_n.astype(jnp.int32)
    probs = jnp.where(keys < N_max, probs, jnp.asarray(jnp.inf, dtype))
    sk, sp = jax.lax.sort((keys, probs), num_keys=2)
    counts = jnp.zeros((N_max + 1,), jnp.int32).at[keys].add(1)[:N_max]
    offsets = jnp.cumsum(counts) - counts
    lo = jnp.clip(offsets + (counts - 1) // 2, 0, path_n.shape[0] - 1)
    hi = jnp.clip(offsets + counts // 2, 0, path_n.shape[0] - 1)
    med = 0.5 * (sp[lo] + sp[hi])
    med = jnp.where(counts > 0, med, 0.0)
    return starts, med


def _walk_single(B: int, N_max: int):
    """Sequential banded traceback as a reverse scan over t, followed by a
    grouped-median reduction over the visited path (ref: NT_banded.cpp:204-250
    + utils.cpp:443-467)."""

    def fn(PM, PE, choices, bstart, T, N, bw):
        T_pad = PM.shape[0]

        def step(carry, xs):
            n, j, is_m = carry
            pm_row, pe_row, ch_row, bs, bs_prev, t = xs
            active = (t <= T - 1) & (n >= 1)
            s = (bs != bs_prev).astype(jnp.int32)
            prob = jnp.where(is_m, pm_row[j], pe_row[j])
            close = active & is_m
            out_n = jnp.where(active, n, N_max)
            start = t - 1
            n_next = jnp.where(close, n - 1, n)
            j_next = jnp.where(
                close, j - 1 + s, jnp.where(active, j + s, j)
            )
            is_m_next = jnp.where(
                close, False, jnp.where(active, ch_row[j], is_m)
            )
            return (n_next, j_next, is_m_next), (out_n, prob, close, start)

        t_idx = jnp.arange(1, T_pad, dtype=jnp.int32)
        xs = (PM[1:], PE[1:], choices[1:], bstart[1:], bstart[:-1], t_idx)
        init = (N - 1, bw + 1, jnp.asarray(False))
        _, (path_n, probs, closes, starts_t) = jax.lax.scan(
            step, init, xs, reverse=True
        )
        return walk_summaries(path_n, probs, closes, starts_t, N_max)

    return fn


def banded_batch_run_device(wire: WireBatch, means_t, c1_t, c2_t, log_m1,
                            log_e2, dtype=jnp.float32,
                            hampel: bool = False) -> DeviceSegResult:
    """Whole-pipeline device program for one padded bucket: the GPU
    kernels where ops/nt_banded_pallas.kernels_enabled says so, the XLA
    scans otherwise."""
    from dynamont_jax.ops import nt_banded_pallas as pk

    decode = jax.vmap(_decode_single(wire, means_t, c1_t, c2_t, dtype, hampel))
    sig, mu_pad, c1_pad, c2_pad, bstart = decode(
        wire.dacs, wire.aff_a, wire.aff_b, wire.kmer_ids, wire.shift_bits,
        wire.T, wire.N, wire.bw,
    )
    batch = bb.BandedBatch(
        sig=sig, mu_pad=mu_pad, c1_pad=c1_pad, c2_pad=c2_pad, bstart=bstart,
        T=wire.T, N=wire.N, bw=wire.bw, pad=wire.pad, B=wire.B,
    )
    if pk.kernels_enabled(dtype):
        Zf, Zb, starts, medians = pk.banded_segment(
            batch, wire.N_max, log_m1, log_e2)
        return DeviceSegResult(Zf=Zf, Zb=Zb, starts=starts, medians=medians)
    res = bb.banded_batch_run(batch, log_m1, log_e2)
    walk = jax.vmap(_walk_single(wire.B, wire.N_max))
    starts, medians = walk(res.PM, res.PE, res.choices, bstart, wire.T,
                           wire.N, wire.bw)
    return DeviceSegResult(Zf=res.Zf, Zb=res.Zb, starts=starts, medians=medians)


def make_device_fn(m1: float, e2: float, means, c1, c2, dtype=jnp.float32,
                   hampel: bool = False):
    """Jitted wire->summaries entry with device-resident model tables.

    The tables are jit *arguments* (device-put once), never closure
    constants — XLA constant-folds gathers from constants element by
    element, which explodes compile time."""
    import functools

    log_m1, log_e2 = math.log(m1), math.log(e2)
    means_np = jnp.asarray(np.asarray(means), dtype)
    c1_np = jnp.asarray(np.asarray(c1), dtype)
    c2_np = jnp.asarray(np.asarray(c2), dtype)
    # one table copy per device the engine dispatches to (round-robin
    # multi-chip inference keeps the tables resident on every chip)
    table_cache: dict = {}

    def _tables(device):
        key = device
        if key not in table_cache:
            if device is None:
                table_cache[key] = (
                    jax.device_put(means_np), jax.device_put(c1_np),
                    jax.device_put(c2_np),
                )
            else:
                table_cache[key] = (
                    jax.device_put(means_np, device),
                    jax.device_put(c1_np, device),
                    jax.device_put(c2_np, device),
                )
        return table_cache[key]

    @functools.partial(
        jax.jit, static_argnames=("pad", "B", "N_max", "T_pad")
    )
    def run_arrays(dacs, aff_a, aff_b, kmer_ids, shift_bits, T, N, bw,
                   mt, c1a, c2a, pad, B, N_max, T_pad):
        wire = WireBatch(dacs, aff_a, aff_b, kmer_ids, shift_bits, T, N, bw,
                         pad, B, N_max, T_pad)
        return banded_batch_run_device(
            wire, mt, c1a, c2a, log_m1, log_e2, dtype, hampel
        )

    def run(wire: WireBatch, device=None) -> DeviceSegResult:
        means_t, c1_t, c2_t = _tables(device)
        return run_arrays(
            wire.dacs, wire.aff_a, wire.aff_b, wire.kmer_ids, wire.shift_bits,
            wire.T, wire.N, wire.bw, means_t, c1_t, c2_t,
            pad=wire.pad, B=wire.B, N_max=wire.N_max, T_pad=wire.T_pad,
        )

    return run


def summaries_to_segments(starts_row: np.ndarray, medians_row: np.ndarray,
                          N: int, kmer_size: int):
    """Host formatting: (N_max,) summaries -> reference-ordered segment list
    [(state, basepos, start_t, median_prob)]."""
    half = kmer_size // 2
    idx = np.nonzero(np.asarray(starts_row[1:N]) >= 0)[0] + 1
    sts = np.asarray(starts_row)[idx].tolist()
    probs = np.asarray(medians_row)[idx].tolist()
    bps = (idx - 1 + half).tolist()
    return [("M", bp, st, p) for bp, st, p in zip(bps, sts, probs)]
