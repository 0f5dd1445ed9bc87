"""BAM ingestion against REAL file bytes (ref: segment.py:226-260).

tests/test_bam_stub.py fakes pysam at the module level, which validates
our tag logic but not the actual byte path. Here a genuine BAM file is
written with pysam's own API and re-read through generate_bam_jobs /
materialize_bam_job — covering BGZF framing, tag typing (f32 vs int),
and the sp/fn fallback behavior on real records. Runs wherever pysam is
installed (CI nightly); skipped in pysam-less images.
"""

import sys
import types

import numpy as np
import pytest

pysam = pytest.importorskip("pysam")

from dynamont_jax.io import readers  # noqa: E402


def _write_bam(path, records):
    header = {"HD": {"VN": "1.6", "SO": "unknown"}}
    with pysam.AlignmentFile(str(path), "wb", header=header) as out:
        for name, seq, tags in records:
            a = pysam.AlignedSegment()
            a.query_name = name
            a.query_sequence = seq
            a.flag = 4  # unmapped, like dorado basecall output
            a.query_qualities = pysam.qualitystring_to_array("I" * len(seq))
            a.set_tags(tags)
            out.write(a)


@pytest.fixture()
def raw_stub(monkeypatch):
    """read5_ont replacement: the pod5 side stays stubbed (no pod5 writer
    in most CI images) — this test targets the BAM byte path."""
    store = {}

    class FakeRaw:
        def __init__(self, path):
            self.path = path

        def getSignal(self, signalid):
            return store[signalid][0]

        def getpASignal(self, signalid):
            return store[signalid][1]

        def close(self):
            pass

    mod = types.SimpleNamespace(read=lambda path: FakeRaw(path))
    monkeypatch.setitem(sys.modules, "read5_ont", mod)
    readers._RAW_CACHE.clear()
    yield store
    readers._RAW_CACHE.clear()


def test_generate_bam_jobs_real_bytes(tmp_path, raw_stub):
    seq = "ACGTACGTACGTACGTACGTACGTACGTAC"
    recs = [
        # full dorado tag set, shift>400 => DAC branch
        ("read1", seq, [("qs", 22.5, "f"), ("ns", 120, "i"), ("ts", 10, "i"),
                        ("sp", 5, "i"), ("pi", "parent1", "Z"),
                        ("fn", "sig.pod5", "Z"), ("sm", 480.5, "f"),
                        ("sd", 22.0, "f")]),
        # missing sp + pi + fn (f5 fallback), shift<=400 => pA branch
        ("read2", seq, [("qs", 15.0, "f"), ("ns", 90, "i"), ("ts", 0, "i"),
                        ("f5", "sig.fast5", "Z"), ("sm", 120.0, "f"),
                        ("sd", 9.5, "f")]),
        # below the quality gate
        ("read3", seq, [("qs", 3.0, "f"), ("ns", 50, "i"), ("ts", 0, "i"),
                        ("fn", "sig.pod5", "Z"), ("sm", 500.0, "f"),
                        ("sd", 10.0, "f")]),
    ]
    bam = tmp_path / "calls.bam"
    _write_bam(bam, recs)
    assert bam.stat().st_size > 0
    # real bytes: BGZF magic
    head = bam.read_bytes()[:4]
    assert head[:2] == b"\x1f\x8b"

    jobs = list(readers.generate_bam_jobs(str(tmp_path), str(bam),
                                          min_qual=10))
    assert len(jobs) == 2  # read3 filtered by qscore

    j1 = jobs[0]
    raw_file, shift, scale, start, end, read, readid, signalid = j1
    assert readid == "read1" and signalid == "parent1"
    assert raw_file.endswith("sig.pod5")
    assert (start, end) == (15, 125)  # sp+ts, sp+ns
    assert shift == pytest.approx(480.5) and scale == pytest.approx(22.0)
    assert read == seq

    j2 = jobs[1]
    assert j2[6] == "read2" and j2[7] == "read2"  # pi fallback -> readid
    assert j2[0].endswith("sig.fast5")  # fn fallback -> f5 tag
    assert (j2[3], j2[4]) == (0, 90)  # sp fallback -> 0

    # materialize: shift>400 picks the DAC signal, normalization applied
    rng = np.random.default_rng(0)
    dac = (rng.normal(500, 20, 200)).astype(np.float64)
    pa = (dac - 480.5) / 22.0 * 7.0  # deliberately different
    raw_stub["parent1"] = (dac, pa)
    job = readers.materialize_bam_job(j1, rna=False)
    want = (dac[15:125] - 480.5) / 22.0
    readers.hampel_filter(want)
    np.testing.assert_allclose(job.signal, want)
    assert job.readid == "read1" and job.sig_offset == 15

    # shift<=400 picks the pA signal
    raw_stub["read2"] = (dac, pa)
    job2 = readers.materialize_bam_job(j2, rna=False)
    want2 = (pa[0:90] - 120.0) / 9.5
    readers.hampel_filter(want2)
    np.testing.assert_allclose(job2.signal, want2)
