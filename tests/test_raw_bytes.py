"""Raw-signal-file REAL bytes coverage.

test_bam_real_bytes.py covers real BAM bytes but stubs the raw side;
here the raw side is REAL: a multi-read fast5 is written with h5py
in-test and read back through the production `materialize_bam_job` path
(io/readers.py) via the internal fast5 fallback reader (io/fast5.py),
exercising BOTH calibration branches — raw DACs (shift > 400, dorado
0.9.x) and pA values (ref: segment.py:117-130, 162-173) — plus the
worker LRU cache, and driving the result end-to-end through the banded
engine.
"""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

import jax.numpy as jnp  # noqa: E402

from dynamont_jax.io import readers  # noqa: E402
from dynamont_jax.io.fast5 import Fast5Reader, write_fast5  # noqa: E402
from dynamont_jax.models.registry import load_model_for_pore  # noqa: E402
from dynamont_jax.utils.signal import (  # noqa: E402
    hampel_filter, prepare_read_sequence,
)
from dynamont_jax.utils.synthetic import make_read  # noqa: E402

DIG, OFF, RNG = 8192.0, 10.0, 1467.61


@pytest.fixture(autouse=True)
def _no_read5(monkeypatch):
    """Force the internal fast5 fallback even if read5_ont existed."""
    import builtins

    real_import = builtins.__import__

    def guard(name, *a, **k):
        if name == "read5_ont":
            raise ImportError("read5_ont disabled for this test")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", guard)
    readers._RAW_CACHE.clear()
    yield
    readers._RAW_CACHE.clear()


def _model_and_read(seed=0):
    model = load_model_for_pore("rna002")
    sig, read = make_read(model, n_bases=40, seed=seed)
    return model, sig, read


def _to_dacs(signal_pa, shift, scale):
    """Invert the pipeline: produce int16 DACs whose calibrated pA land
    near the given normalized signal (pA = normalized * scale + shift;
    DAC = pA * dig / range - offset)."""
    pa = np.asarray(signal_pa) * scale + shift
    dacs = np.round(pa * DIG / RNG - OFF).astype(np.int16)
    return dacs


def test_fast5_reader_roundtrip(tmp_path):
    """Byte-level roundtrip: DACs as stored; pA via the ONT calibration."""
    path = str(tmp_path / "batch0.fast5")
    dacs = np.array([100, 200, -5, 3000], np.int16)
    write_fast5(path, {"readA": dacs}, digitisation=DIG, offset=OFF,
                rng=RNG)
    r = Fast5Reader(path)
    got = r.getSignal("readA")
    assert got.dtype == np.int16 and np.array_equal(got, dacs)
    pa = r.getpASignal("readA")
    expect = (dacs.astype(np.float64) + OFF) * RNG / DIG
    np.testing.assert_allclose(pa, expect, rtol=0, atol=0)
    r.close()


def test_materialize_bam_job_dac_branch(tmp_path):
    """shift > 400 selects raw DACs (dorado 0.9.x): signal bytes from the
    actual fast5 dataset, sliced [sp+ts, sp+ns), normalized (x-sm)/sd,
    hampel-filtered (ref: segment.py:162-173)."""
    _, sig, read = _model_and_read()
    shift, scale = 480.0, 25.0
    dacs = _to_dacs(sig, shift, scale)
    pad = np.zeros(7, np.int16)  # ts/sp slicing must matter
    full = np.concatenate([pad, dacs, pad])
    path = str(tmp_path / "b.fast5")
    write_fast5(path, {"sigA": full})
    start, end = 7, 7 + len(dacs)
    job = readers.materialize_bam_job(
        (path, shift, scale, start, end, read, "readA", "sigA"), rna=True)
    expect = (full[start:end].astype(np.float64) - shift) / scale
    hampel_filter(expect)
    np.testing.assert_array_equal(job.signal, expect)
    assert job.read == prepare_read_sequence(read, True)
    assert job.read_5to3 == read and job.sig_offset == start


def test_materialize_bam_job_pa_branch_and_cache(tmp_path):
    """shift <= 400 selects calibrated pA; multiple files exercise the
    LRU raw cache (ref: segment.py:117-130, cache of 4 open files)."""
    _, sig, read = _model_and_read(seed=1)
    shift, scale = 80.0, 9.0   # pA-scale normalization params
    pa_target = np.asarray(sig) * scale + shift
    dacs = np.round(pa_target * DIG / RNG - OFF).astype(np.int16)
    paths = []
    for i in range(5):  # one more than the cache size -> eviction
        p = str(tmp_path / f"b{i}.fast5")
        write_fast5(p, {f"sig{i}": dacs})
        paths.append(p)
    jobs = []
    for i, p in enumerate(paths):
        jobs.append(readers.materialize_bam_job(
            (p, shift, scale, 0, len(dacs), read, f"r{i}", f"sig{i}"),
            rna=True))
    assert len(readers._RAW_CACHE) == readers._RAW_CACHE_SIZE
    pa = (dacs.astype(np.float64) + OFF) * RNG / DIG
    expect = (pa - shift) / scale
    hampel_filter(expect)
    for job in jobs:
        np.testing.assert_array_equal(job.signal, expect)


def test_raw_bytes_end_to_end_segmentation(tmp_path):
    """fast5 bytes -> materialize_bam_job -> banded engine -> segments:
    the full production ingest path on real raw bytes."""
    from dynamont_jax.models.batch import BandedBatchEngine, BatchItem

    model, sig, read = _model_and_read(seed=2)
    shift, scale = 470.0, 20.0
    dacs = _to_dacs(sig, shift, scale)
    path = str(tmp_path / "b.fast5")
    write_fast5(path, {"sigX": dacs})
    job = readers.materialize_bam_job(
        (path, shift, scale, 0, len(dacs), read, "rX", "sigX"), rna=True)
    eng = BandedBatchEngine(model, "rna002", dtype=jnp.float64)
    outs = eng.run([BatchItem(job.signal, job.read)])
    assert outs[0].error is None
    assert outs[0].segments is not None and len(outs[0].segments) > 0
