"""BAM/pod5 ingestion path exercised with stub pysam/read5_ont modules.

The production input path (io/readers.generate_bam_jobs +
materialize_bam_job, ref: segment.py:193-262) needs pysam/read5_ont which
this image lacks; these stubs emulate the dorado tag contract (qs/ns/ts/
sp/pi/fn/sm/sd incl. the sp/fn fallbacks and the shift>400 DAC heuristic)
so the whole resquiggle CLI runs end-to-end without them.
"""

import io
import sys
import types

import numpy as np
import pytest
import zstandard as zstd

from dynamont_jax.models.registry import load_model_for_pore
from tests.synthetic import make_read


class FakeBamRead:
    def __init__(self, name, seq, tags):
        self.query_name = name
        self.query_sequence = seq
        self._tags = tags

    def has_tag(self, tag):
        return tag in self._tags

    def get_tag(self, tag):
        return self._tags[tag]


class FakeAlignmentFile:
    reads: list = []

    def __init__(self, path, mode, check_sq=False):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def fetch(self, until_eof=False):
        yield from self.reads


class FakeRaw:
    """read5_ont file handle stub; records which accessor was used."""

    opened: list = []
    dac_calls: list = []
    pa_calls: list = []
    signals: dict = {}

    def __init__(self, path):
        self.path = path
        FakeRaw.opened.append(path)

    def getSignal(self, signalid):
        FakeRaw.dac_calls.append(signalid)
        return self.signals[signalid]["dac"]

    def getpASignal(self, signalid):
        FakeRaw.pa_calls.append(signalid)
        return self.signals[signalid]["pa"]

    def close(self):
        pass


@pytest.fixture()
def stub_modules(monkeypatch):
    pysam = types.ModuleType("pysam")
    pysam.AlignmentFile = FakeAlignmentFile
    read5 = types.ModuleType("read5_ont")
    read5.read = FakeRaw
    monkeypatch.setitem(sys.modules, "pysam", pysam)
    monkeypatch.setitem(sys.modules, "read5_ont", read5)
    FakeAlignmentFile.reads = []
    FakeRaw.opened = []
    FakeRaw.dac_calls = []
    FakeRaw.pa_calls = []
    FakeRaw.signals = {}
    # the worker LRU cache persists across tests — clear it
    from dynamont_jax.io import readers

    readers._RAW_CACHE.clear()
    return pysam, read5


def _make_bam_read(model, seed, name, *, shift, scale, sp=100, pad=50,
                   use_fn=True, qs=20.0):
    """Synthesize a read whose RAW slice reproduces make_read's signal
    after (x - shift) / scale, embedded at offset sp+ts in a longer DAC
    trace."""
    sig, read = make_read(model, n_bases=25, seed=seed)
    raw = sig * scale + shift
    full = np.concatenate(
        [np.zeros(sp), np.zeros(pad), raw, np.zeros(pad)]
    )
    ts = pad
    ns = ts + len(sig)  # slice [sp+ts : sp+ns] recovers `raw`
    tags = {"qs": qs, "ns": ns, "ts": ts, "sm": shift, "sd": scale,
            "sp": sp, "pi": f"sig_{name}"}
    if use_fn:
        tags["fn"] = f"{name}.pod5"
    else:
        tags["f5"] = f"{name}.fast5"
    return FakeBamRead(name, read, tags), full, sig


def test_generate_and_materialize_bam_jobs(stub_modules):
    from dynamont_jax.io import readers

    model = load_model_for_pore("rna002")
    # read A: pA path (shift <= 400); read B: DAC path (shift > 400, and
    # fn-tag missing -> f5 fallback); read C: filtered by qscore
    ra, full_a, sig_a = _make_bam_read(model, 0, "A", shift=10.0, scale=2.0)
    rb, full_b, sig_b = _make_bam_read(
        model, 1, "B", shift=500.0, scale=20.0, use_fn=False, sp=0
    )
    rc, _, _ = _make_bam_read(model, 2, "C", shift=10.0, scale=2.0, qs=3.0)
    FakeAlignmentFile.reads = [ra, rb, rc]
    FakeRaw.signals = {
        "sig_A": {"pa": full_a, "dac": np.zeros_like(full_a)},
        "sig_B": {"dac": full_b, "pa": np.zeros_like(full_b)},
    }

    jobs = list(readers.generate_bam_jobs("/raw", "fake.bam", min_qual=10))
    assert len(jobs) == 2  # C dropped by the qscore filter
    assert jobs[0][0] == "/raw/A.pod5"
    assert jobs[1][0] == "/raw/B.fast5"  # f5 fallback

    job_a = readers.materialize_bam_job(jobs[0], rna=True)
    assert FakeRaw.pa_calls == ["sig_A"]       # shift<=400 -> pA values
    job_b = readers.materialize_bam_job(jobs[1], rna=True)
    assert FakeRaw.dac_calls == ["sig_B"]      # shift>400 -> raw DACs
    # normalization recovers the synthetic signal (hampel may smooth a few
    # outliers; compare medians of the difference)
    assert job_a.sig_offset == 150 and len(job_a.signal) == len(sig_a)
    assert np.median(np.abs(job_a.signal - sig_a)) < 1e-9
    assert np.median(np.abs(job_b.signal - sig_b)) < 1e-9
    # RNA orientation: reversed + polyA prefix (ref: segment.py:176-179)
    assert job_a.read == "A" * 9 + ra.query_sequence[::-1]
    # LRU cache reuses the open handle per file
    readers.materialize_bam_job(jobs[0], rna=True)
    assert FakeRaw.opened.count("/raw/A.pod5") == 1


@pytest.mark.slow
def test_resquiggle_cli_bam_end_to_end(stub_modules, tmp_path):
    """Full dynamont-resquiggle over the stubbed BAM source (basic mode)."""
    from dynamont_jax.cli import resquiggle

    model = load_model_for_pore("rna002")
    ra, full_a, _ = _make_bam_read(model, 0, "A", shift=10.0, scale=2.0)
    rb, full_b, _ = _make_bam_read(model, 1, "B", shift=450.0, scale=20.0)
    FakeAlignmentFile.reads = [ra, rb]
    FakeRaw.signals = {
        "sig_A": {"pa": full_a, "dac": np.zeros_like(full_a)},
        "sig_B": {"dac": full_b, "pa": np.zeros_like(full_b)},
        # note: B uses the DAC branch
    }
    out = tmp_path / "out.csv.zst"
    resquiggle.main([
        "--raw", "/raw", "--basecalls", "fake.bam", "-o", str(out),
        "--mode", "basic", "-p", "rna002",
    ])
    text = zstd.ZstdDecompressor().stream_reader(out.open("rb")).read().decode()
    lines = text.strip().splitlines()
    assert lines[0].startswith("readid,signalid,start,end,basepos,base,motif")
    rids = {ln.split(",")[0] for ln in lines[1:]}
    assert rids == {"A", "B"}
    # segment starts are absolute signal coordinates (sig_offset applied)
    a_starts = [int(ln.split(",")[2]) for ln in lines[1:]
                if ln.split(",")[0] == "A"]
    assert min(a_starts) >= 150
