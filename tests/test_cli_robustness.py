"""CLI failure-isolation tests: a crashed engine chunk is isolated per
read, the offending read gets a repro dump (reference stdin format, like
the reference's training dump FileIO.py:281-283), and the run continues."""

import os

import numpy as np
import pytest
import zstandard as zstd

from dynamont_jax.models.registry import load_model_for_pore

from tests.synthetic import make_read


@pytest.fixture(scope="module")
def model():
    return load_model_for_pore("rna002")


def _write_tsv(path, items):
    with open(path, "w") as f:
        for rid, sig, read in items:
            f.write(
                f"{rid}\t{rid}\t{','.join(repr(float(x)) for x in sig)}"
                f"\t{read}\n")


def _read_zst_csv(path):
    with open(path, "rb") as f:
        data = zstd.ZstdDecompressor().stream_reader(
            f, read_across_frames=True).read()
    lines = data.decode().strip().split("\n")
    return lines[0], [ln.split(",") for ln in lines[1:]]


def test_engine_crash_isolated_with_repro_dump(model, tmp_path, monkeypatch):
    from dynamont_jax.cli import resquiggle
    from dynamont_jax.models.batch import BandedBatchEngine

    items = []
    for s in range(3):
        sig, read_proc = make_read(model, n_bases=40, seed=140 + s)
        items.append((f"read{s}", sig, read_proc[9:][::-1]))
    tsv = tmp_path / "reads.tsv"
    _write_tsv(tsv, items)
    out = tmp_path / "out.csv.zst"

    # collect() raises for multi-read chunks; the per-read isolation then
    # goes through run(), where only readid "read1" keeps crashing
    orig_collect = BandedBatchEngine.collect
    orig_run = BandedBatchEngine.run

    def crashing_collect(self, handle):
        if len(handle[0]) > 1:
            raise RuntimeError("synthetic chunk crash")
        return orig_collect(self, handle)

    def crashing_run(self, batch_items):
        if any(getattr(it.meta, "readid", None) == "read1"
               for it in batch_items):
            raise RuntimeError("synthetic per-read crash")
        return orig_run(self, batch_items)

    monkeypatch.setattr(BandedBatchEngine, "collect", crashing_collect)
    monkeypatch.setattr(BandedBatchEngine, "run", crashing_run)
    monkeypatch.chdir(tmp_path)  # the dump lands in cwd
    resquiggle.main([
        "--tsv", str(tsv), "-o", str(out), "--mode", "basic", "-p", "rna002",
    ])
    # the two healthy reads got segmented
    _, rows = _read_zst_csv(out)
    assert {r[0] for r in rows} == {"read0", "read2"}
    # the crashing read: sidecar error + repro dump in stdin format
    err = open(tmp_path / "out.errors").read()
    assert "engine exception" in err and "read1" in err
    dump = tmp_path / "failed_input_read1.txt"
    assert dump.exists()
    sig_line, read_line = dump.read_text().strip().split("\n")
    # the dump carries the PROCESSED signal/read (what the engine actually
    # saw — that is what reproduces the failure)
    assert len(np.fromstring(sig_line, sep=",")) == len(items[1][1])
    assert set(read_line) <= set("ACGTU") and len(read_line) >= len(
        items[1][2])
