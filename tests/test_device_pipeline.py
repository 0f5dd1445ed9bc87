"""Device-resident pipeline (wire format + on-device walk) parity tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from dynamont_jax.models.batch import BandedBatchEngine, BatchItem
from dynamont_jax.models.nt_banded import run_nt_banded
from dynamont_jax.models.registry import load_model_for_pore
from dynamont_jax.ops import nt_banded_device as dv
from dynamont_jax.utils.signal import hampel_filter

from tests.synthetic import make_read


@pytest.fixture(scope="module")
def model():
    return load_model_for_pore("rna002")


def _quantized_items(model, n_reads=4, base_len=45):
    """Signals pre-snapped to the int16 grid so wire quantization is lossless
    and fp64 parity is exact."""
    items = []
    for s in range(n_reads):
        sig, read = make_read(model, n_bases=base_len + 9 * s, seed=100 + s)
        dac, a, b = dv.quantize_signal(sig)
        items.append(BatchItem(signal=dac.astype(np.float64) * a + b, read=read))
    return items


def test_device_pipeline_exact_fp64(model):
    items = _quantized_items(model)
    eng = BandedBatchEngine(model, "rna002", dtype=jnp.float64, batch_size=3)
    outs = eng.run(items)
    for it, out in zip(items, outs):
        assert out.error is None, out.error
        ref = run_nt_banded(it.signal, it.read, model, "rna002")
        assert len(out.segments) == len(ref.segments)
        for got, want in zip(out.segments, ref.segments):
            assert got[:3] == want[:3]
            assert got[3] == pytest.approx(want[3], abs=1e-12)
        assert out.Z == pytest.approx(ref.Z, rel=1e-12)


def test_device_pipeline_fp32_borders(model):
    items = _quantized_items(model, n_reads=3, base_len=60)
    eng = BandedBatchEngine(model, "rna002", dtype=jnp.float32)
    outs = eng.run(items)
    for it, out in zip(items, outs):
        assert out.error is None, out.error
        ref = run_nt_banded(it.signal, it.read, model, "rna002")
        assert [(s[1], s[2]) for s in out.segments] == [
            (s[1], s[2]) for s in ref.segments
        ]
        for got, want in zip(out.segments, ref.segments):
            assert got[3] == pytest.approx(want[3], abs=2e-3)


def test_device_hampel_matches_host(model):
    rng = np.random.default_rng(7)
    import jax

    for L in (5, 17, 256):
        sig = rng.normal(0, 1, L)
        sig[L // 2] = 40.0  # an outlier
        want = hampel_filter(sig.copy())
        got = np.asarray(
            dv.hampel3_device(jnp.asarray(sig, jnp.float64), jnp.asarray(L))
        )
        np.testing.assert_allclose(got, want, atol=0, rtol=0)


def test_wire_quantization_error_bound():
    rng = np.random.default_rng(3)
    sig = rng.normal(0, 1.0, 5000)
    dac, a, b = dv.quantize_signal(sig)
    err = np.abs(dac.astype(np.float64) * a + b - sig)
    assert err.max() < 1e-4


def test_fp32_z_gate_escalates_to_fp64(model, monkeypatch):
    """A read that fails the batched fp32 Z gate is NOT lost: it re-runs
    on the exact per-read fp64 path (mirroring the NTC ladder) and yields
    the fp64 segments. fp64 gate failures stay terminal (reference
    exit-3 contract, NT_banded_main.cpp:156-183)."""
    from dynamont_jax.ops import nt_banded_batch as bb

    items = _quantized_items(model, n_reads=2, base_len=50)
    eng = BandedBatchEngine(model, "rna002", dtype=jnp.float32)
    # force the fp32 gate to fail for every read in the bucket
    monkeypatch.setattr(
        bb, "check_z_batch",
        lambda Zf, Zb, T, B, dtype: np.zeros(len(np.asarray(Zf)), bool),
    )
    outs = eng.run(items)
    assert eng.profile.get("z_retries", 0) == len(items)
    for it, out in zip(items, outs):
        assert out.error is None, out.error
        ref = run_nt_banded(it.signal, it.read, model, "rna002")
        assert [(s[1], s[2]) for s in out.segments] == [
            (s[1], s[2]) for s in ref.segments
        ]
        assert out.Z == pytest.approx(ref.Z, rel=1e-12)


def test_fp32_z_gate_terminal_without_fallback(model, monkeypatch):
    from dynamont_jax.ops import nt_banded_batch as bb

    items = _quantized_items(model, n_reads=1, base_len=50)
    eng = BandedBatchEngine(
        model, "rna002", dtype=jnp.float32, fp64_fallback=False
    )
    monkeypatch.setattr(
        bb, "check_z_batch",
        lambda Zf, Zb, T, B, dtype: np.zeros(len(np.asarray(Zf)), bool),
    )
    outs = eng.run(items)
    assert outs[0].error is not None
    assert "Z values between matrices" in outs[0].error
