"""Batched banded engine: parity vs the exact-parity single-read path."""

import jax.numpy as jnp
import numpy as np
import pytest

from dynamont_jax.models.batch import BandedBatchEngine, BatchItem
from dynamont_jax.models.nt_banded import run_nt_banded
from dynamont_jax.models.registry import load_model_for_pore
from dynamont_jax.ops import nt_banded_batch as bb
from dynamont_jax.utils.kmer import seq_to_kmer_ids

from tests.synthetic import make_read


@pytest.fixture(scope="module")
def model():
    return load_model_for_pore("rna002")


def _items(model, n_reads=5, base_len=40):
    items = []
    for s in range(n_reads):
        sig, read = make_read(model, n_bases=base_len + 13 * s, seed=s)
        items.append(BatchItem(signal=sig, read=read))
    return items


def test_batched_matches_single_read_fp64(model):
    items = _items(model)
    # matrix path (device_pipeline=False): no wire quantization, so raw
    # float64 signals round-trip exactly (the device path is covered by
    # test_device_pipeline with grid-snapped signals)
    eng = BandedBatchEngine(
        model, "rna002", dtype=jnp.float64, batch_size=3, device_pipeline=False
    )
    outs = eng.run(items)
    for it, out in zip(items, outs):
        assert out.error is None, out.error
        ref = run_nt_banded(it.signal, it.read, model, "rna002")
        assert out.segments is not None
        assert len(out.segments) == len(ref.segments)
        for got, want in zip(out.segments, ref.segments):
            assert got[0] == want[0]
            assert got[1] == want[1]
            assert got[2] == want[2]
            # medians ride through float32 probabilities on the batched path;
            # the CSV prints 5 decimals so 1e-6 is far below output precision
            assert got[3] == pytest.approx(want[3], abs=1e-6)
        assert out.Z == pytest.approx(ref.Z, rel=1e-12)


def test_batched_fp32_borders_match(model):
    """fp32 production dtype: same MAP borders, medians to ~1e-3."""
    items = _items(model, n_reads=4, base_len=50)
    eng = BandedBatchEngine(
        model, "rna002", dtype=jnp.float32, device_pipeline=False
    )
    outs = eng.run(items)
    for it, out in zip(items, outs):
        assert out.error is None, out.error
        ref = run_nt_banded(it.signal, it.read, model, "rna002")
        got_borders = [(s[1], s[2]) for s in out.segments]
        want_borders = [(s[1], s[2]) for s in ref.segments]
        assert got_borders == want_borders
        for got, want in zip(out.segments, ref.segments):
            assert got[3] == pytest.approx(want[3], abs=2e-3)


def test_z_invariant_per_read(model):
    items = _items(model, n_reads=3)
    kmer_ids = [
        seq_to_kmer_ids(it.read, model.kmer_size, model.alphabet_size) for it in items
    ]
    batch = bb.prepare_batch(
        [it.signal for it in items], kmer_ids, model.means, model.stdevs,
        dtype=jnp.float64,
    )
    run = bb.make_banded_batch_fn(0.019889650396799997, 0.9801103496029998)
    res = run(batch)
    ok = bb.check_z_batch(
        np.asarray(res.Zf), np.asarray(res.Zb), np.asarray(batch.T), batch.B,
        jnp.float64,
    )
    assert ok.all()


def test_validation_errors_are_reported(model):
    items = [BatchItem(signal=np.zeros(4), read="ACGTACGTAC")]
    eng = BandedBatchEngine(model, "rna002")
    outs = eng.run(items)
    assert outs[0].segments is None
    assert "validation" in outs[0].error


def test_native_traceback_matches_python(model):
    from dynamont_jax import native

    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    items = _items(model, n_reads=2)
    kmer_ids = [
        seq_to_kmer_ids(it.read, model.kmer_size, model.alphabet_size) for it in items
    ]
    batch = bb.prepare_batch(
        [it.signal for it in items], kmer_ids, model.means, model.stdevs,
        dtype=jnp.float64,
    )
    run = bb.make_banded_batch_fn(0.019889650396799997, 0.9801103496029998)
    res = run(batch)
    choices = np.asarray(res.choices)
    PM = np.asarray(res.PM, dtype=np.float32)
    PE = np.asarray(res.PE, dtype=np.float32)
    bstart = np.asarray(batch.bstart)
    T, N, bw = np.asarray(batch.T), np.asarray(batch.N), np.asarray(batch.bw)
    got = native.banded_traceback_batch(choices, PM, PE, bstart, T, N, bw, model.kmer_size)
    for i in range(len(items)):
        want = native._banded_traceback_py(
            choices[i], PM[i], PE[i], bstart[i], int(T[i]), int(N[i]), int(bw[i]),
            model.kmer_size // 2,
        )
        assert got[i] == pytest.approx(want)


def test_empty_and_mixed_batches(model):
    eng = BandedBatchEngine(model, "rna002", device_pipeline=False)
    assert eng.run([]) == []
    # invalid read mixed with a valid one: both get a result in order
    good_sig, good_read = make_read(model, n_bases=40, seed=3)
    outs = eng.run([
        BatchItem(signal=np.zeros(4), read="ACGTACGTAC"),
        BatchItem(signal=good_sig, read=good_read),
    ])
    assert outs[0].segments is None and outs[0].error
    assert outs[1].error is None and outs[1].segments
