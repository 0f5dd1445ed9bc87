"""Batched NTC pipeline vs the exact per-read fp64 path.

The per-read path (models/ntc.run_ntc) is itself parity-tested against the
reference dynamont-NTC binary (test_ntc_segment.py), so agreement here
transitively establishes reference parity for the production batched
engine.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dynamont_jax.models.batch import BatchItem
from dynamont_jax.models.ntc import run_ntc
from dynamont_jax.models.ntc_batch import NTCBatchEngine
from dynamont_jax.models.registry import load_model_for_pore

from tests.synthetic import make_read


@pytest.fixture(scope="module")
def model():
    return load_model_for_pore("rna002")


@pytest.fixture(scope="module")
def reads(model):
    # ragged lengths: exercises per-read (T, N) masking inside one bucket
    out = []
    for seed, n_bases in [(0, 25), (1, 31), (2, 18), (3, 25)]:
        sig, read = make_read(model, n_bases=n_bases, seed=seed)
        out.append((sig, read))
    return out


@pytest.fixture(scope="module")
def exact(model, reads):
    return [run_ntc(sig, read, model, "rna002") for sig, read in reads]


def _engine(model, dtype, **kw):
    kw.setdefault("t_pad_to", 64)
    kw.setdefault("n_pad_to", 16)
    return NTCBatchEngine(model, "rna002", dtype=dtype, **kw)


def test_topk_maxmask_matches_lax_topk():
    """Iterative max-extraction == lax.top_k through the select_topk
    contract (ties, exhausted columns, dead columns)."""
    import jax

    from dynamont_jax.ops.ntc_batch import _topk_maxmask, select_topk

    rng = np.random.default_rng(0)
    U = rng.normal(size=(64, 256))
    U[1, 5:] = -np.inf                      # exhausted column
    U[2, 10] = U[2, 20] = U[2, 30] = 3.0    # ties -> lower index first
    U = jnp.asarray(U)
    v1, i1 = _topk_maxmask(U, 8)
    v2, i2 = jax.lax.top_k(U, 8)
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
    fin = np.isfinite(np.asarray(v2))   # -inf tail indices are unreachable
    np.testing.assert_array_equal(np.asarray(i1)[fin], np.asarray(i2)[fin])
    # full select_topk contract vs a top_k-forced oracle of the same math
    import math

    from dynamont_jax.ops.ntc_pre import SPARSE_THRESHOLD

    live = jnp.ones((64,), bool)
    c1, n1, o1 = select_topk(U, 8, True, live, 256)
    vals, idx = jax.lax.top_k(U, 8)
    m = vals[:, :1]
    ms = jnp.where(jnp.isfinite(m), m, 0.0)
    tot = jnp.sum(jnp.exp(U - ms), axis=1, keepdims=True)
    run = jnp.cumsum(jnp.exp(vals - ms), axis=1)
    crossed = (run >= math.exp(SPARSE_THRESHOLD) * tot) & jnp.isfinite(m)
    prev = jnp.concatenate(
        [jnp.zeros_like(crossed[:, :1]), crossed[:, :-1]], axis=1)
    inc = ~prev & live[:, None]
    np.testing.assert_array_equal(
        np.asarray(c1), np.asarray(jnp.where(inc, idx, 256)))
    np.testing.assert_array_equal(np.asarray(n1), np.asarray(inc.sum(1)))
    np.testing.assert_array_equal(
        np.asarray(o1), np.asarray(live & ~crossed[:, -1]))


@pytest.mark.slow
def test_batched_fp64_matches_per_read(model, reads, exact):
    eng = _engine(model, jnp.float64)
    outs = eng.run([BatchItem(sig, read) for sig, read in reads])
    for out, res in zip(outs, exact):
        assert out.error is None, out.error
        assert abs(out.Z - res.Z) < 1e-6 * max(1.0, abs(res.Z))
        assert len(out.segments) == len(res.segments)
        for g, r in zip(out.segments, res.segments):
            assert g[0] == r[0] and g[1] == r[1] and g[2] == r[2]
            # fp64 logsumexp reduction orders differ between the batched and
            # per-read paths -> ~1e-8 relative drift in posteriors
            assert abs(g[3] - r[3]) < 1e-6
            assert g[4] == r[4]


@pytest.mark.slow
def test_batched_fp32_borders_match(model, reads, exact):
    eng = _engine(model, jnp.float32)
    outs = eng.run([BatchItem(sig, read) for sig, read in reads])
    n_mismatch = total = 0
    for out, res in zip(outs, exact):
        assert out.error is None, out.error
        assert abs(out.Z - res.Z) < 1e-3 * max(1.0, abs(res.Z))
        assert len(out.segments) == len(res.segments)
        for g, r in zip(out.segments, res.segments):
            total += 1
            same = (
                g[0] == r[0] and g[1] == r[1] and g[2] == r[2]
                and abs(g[3] - r[3]) < 5e-3 and g[4] == r[4]
            )
            n_mismatch += 0 if same else 1
    # fp32 near-ties may flip an occasional segment; demand ~full agreement
    assert n_mismatch <= max(1, total // 50), f"{n_mismatch}/{total}"


@pytest.mark.slow
def test_batched_single_read_bucket(model, reads, exact):
    """A one-read bucket (R=1) must behave identically."""
    sig, read = reads[0]
    eng = _engine(model, jnp.float64)
    outs = eng.run([BatchItem(sig, read)])
    assert outs[0].error is None
    _assert_segments_close(outs[0].segments, exact[0].segments)


def _assert_segments_close(got, want, tol=1e-6):
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert g[0] == r[0] and g[1] == r[1] and g[2] == r[2] and g[4] == r[4]
        assert abs(g[3] - r[3]) < tol


@pytest.mark.slow
def test_overflow_falls_back_to_exact(model, reads, exact):
    """Tiny caps force candidate overflow -> per-read fp64 fallback
    (wide rung disabled so the exact path is what actually runs)."""
    eng = _engine(model, jnp.float64, cap_n=2, cap_k=2, wide_retry=False)
    sig, read = reads[0]
    outs = eng.run([BatchItem(sig, read)])
    assert outs[0].error is None
    assert eng.profile["exact_retries"] == 1
    # the fallback IS the per-read path -> exact equality
    assert outs[0].segments == exact[0].segments


@pytest.mark.slow
def test_overflow_wide_cap_rung(model, reads, exact):
    """Tiny caps overflow -> the doubled-cap scan-path rung repairs the
    read in one shared bucket, never reaching the per-read fp64 cliff."""
    eng = _engine(model, jnp.float64, cap_n=2, cap_k=2)
    outs = eng.run([BatchItem(sig, read) for sig, read in reads])
    assert eng.profile["wide_retries"] == len(reads)
    assert eng.profile["exact_retries"] == 0
    for out, res in zip(outs, exact):
        assert out.error is None, out.error
        assert abs(out.Z - res.Z) < 1e-6 * max(1.0, abs(res.Z))
        _assert_segments_close(out.segments, res.segments)


def test_ckpt_tk_pre_pass_bit_equals_dense():
    """pre_tk_batch_ckpt (checkpoint-recompute, O(T/chunk*K) memory — the
    native-9-mer production path) must reproduce pre_tk_batch exactly:
    the recomputed backward columns follow the identical op order."""
    import math

    from dynamont_jax.constants import NT_TRANSITIONS
    from dynamont_jax.ops import ntc_batch as nb

    model = load_model_for_pore("rna002")
    nt = NT_TRANSITIONS["rna002"]
    lm, le = math.log(nt["m1"]), math.log(nt["e2"])
    mu, c1, c2 = model.score_params()
    sigs = [make_read(model, n_bases=20 + 5 * s, seed=s)[0]
            for s in range(3)]
    T_arr = np.array([len(s) + 1 for s in sigs], np.int32)
    sigp = np.zeros((3, 511))
    for j, s in enumerate(sigs):
        sigp[j, : len(s)] = s
    for dt in (jnp.float64, jnp.float32):
        a = nb.pre_tk_batch(jnp.asarray(sigp), jnp.asarray(T_arr),
                            mu, c1, c2, lm, le, 4, 24, dt)
        b = nb.pre_tk_batch_ckpt(jnp.asarray(sigp), jnp.asarray(T_arr),
                                 mu, c1, c2, lm, le, 4, 24, dt, chunk=64)
        for f in a._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                err_msg=f"{dt.__name__} {f}")


def test_bigk_plan_equals_full_plan():
    """_build_plan_one bigk=True (eq-broadcast k-maps, no (T, K+1)
    scatter tables — the native-9-mer production path) == the full plan
    field-for-field at 5-mer shapes."""
    import math

    from dynamont_jax.constants import NT_TRANSITIONS
    from dynamont_jax.ops import ntc_batch as nb
    from dynamont_jax.utils.kmer import seq_to_kmer_ids

    model = load_model_for_pore("rna002")
    nt = NT_TRANSITIONS["rna002"]
    lm, le = math.log(nt["m1"]), math.log(nt["e2"])
    mu, c1, c2 = model.score_params()
    sigs, kids = [], []
    for s in range(3):
        sig, read = make_read(model, n_bases=20 + 5 * s, seed=s)
        sigs.append(sig)
        kids.append(np.asarray(seq_to_kmer_ids(read, 5, 4), np.int32))
    T_arr = np.array([len(s) + 1 for s in sigs], np.int32)
    N_arr = np.array([len(k) + 1 for k in kids], np.int32)
    sigp = np.zeros((3, 511))
    kidp = np.zeros((3, 47), np.int32)
    for j in range(3):
        sigp[j, : len(sigs[j])] = sigs[j]
        kidp[j, : len(kids[j])] = kids[j]
    dt = jnp.float64
    pn = nb.pre_tn_batch(jnp.asarray(sigp), jnp.asarray(kidp),
                         jnp.asarray(N_arr), jnp.asarray(T_arr),
                         mu, model.stdevs, lm, le, 8, dt)
    pk = nb.pre_tk_batch(jnp.asarray(sigp), jnp.asarray(T_arr),
                         mu, c1, c2, lm, le, 4, 24, dt)
    args = (pn.cand, pn.cnt, pk.cand, pk.cnt, jnp.asarray(kidp),
            jnp.asarray(N_arr), mu, c1, c2, 4, 5, dt)
    full, df = nb.build_plan_batch(*args)
    big, db = nb.build_plan_batch(*args, bigk=True)
    assert df == db
    live = np.asarray(full.live)
    for f in full._fields:
        x, y = np.asarray(getattr(full, f)), np.asarray(getattr(big, f))
        if f == "from_tk":
            # only consumed via `allowed` (live-gated): the bigk dedup
            # skips membership tests for dead duplicate slots
            x, y = x & live, y & live
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_select_topk_bigk_block_merge_matches_oracle():
    """The two-stage block-merge selection (W >= 32768, the native-9-mer
    path) == the full-width top_k oracle, incl. adversarial clustering
    of the top values inside single blocks."""
    import math

    import jax

    from dynamont_jax.ops.ntc_batch import select_topk
    from dynamont_jax.ops.ntc_pre import SPARSE_THRESHOLD

    rng = np.random.default_rng(1)
    W = 65536
    U = rng.normal(-40, 8, size=(4, W))
    U[0, 100:50000] = -np.inf
    U[1, :] = np.sort(U[1, :])[::-1].copy()  # top values in the low blocks
    U[2, :256] = 50.0 + np.arange(256) * 1e-9  # one block holds the top
    live = jnp.ones((4,), bool)
    c1, n1, o1 = select_topk(jnp.asarray(U), 120, True, live, W)
    vals, idx = jax.lax.top_k(jnp.asarray(U), 120)
    m = vals[:, :1]
    ms = jnp.where(jnp.isfinite(m), m, 0.0)
    tot = jnp.sum(jnp.exp(jnp.asarray(U) - ms), axis=1, keepdims=True)
    run = jnp.cumsum(jnp.exp(vals - ms), axis=1)
    crossed = (run >= math.exp(SPARSE_THRESHOLD) * tot) & jnp.isfinite(m)
    prev = jnp.concatenate(
        [jnp.zeros_like(crossed[:, :1]), crossed[:, :-1]], axis=1)
    inc = ~prev & live[:, None]
    np.testing.assert_array_equal(
        np.asarray(c1), np.asarray(jnp.where(inc, idx, W)))
    np.testing.assert_array_equal(np.asarray(n1), np.asarray(inc.sum(1)))
    np.testing.assert_array_equal(
        np.asarray(o1), np.asarray(live & ~crossed[:, -1]))


@pytest.mark.slow
def test_wide_rung_z_failure_escalates_to_exact(model, reads, exact,
                                                monkeypatch):
    """A wide-rung Z-gate failure must NOT be terminal: the read goes on
    to the exact fp64 path (which the pre-rung ladder used directly)."""
    eng = _engine(model, jnp.float64, cap_n=2, cap_k=2)
    orig = NTCBatchEngine._z_errors

    def fake(self, host, j, T, N, K, caps=None):
        # the wide rung passes its widened caps explicitly (it no longer
        # mutates engine state); detect it by that argument
        if caps is not None and caps[0] >= 16:
            return "Z values between matrices do not match! (forced)"
        return orig(self, host, j, T, N, K, caps=caps)

    monkeypatch.setattr(NTCBatchEngine, "_z_errors", fake)
    sig, read = reads[0]
    outs = eng.run([BatchItem(sig, read)])
    assert eng.profile["wide_retries"] == 1
    assert eng.profile["exact_retries"] == 1
    assert outs[0].error is None
    assert outs[0].segments == exact[0].segments
