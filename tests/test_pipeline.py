"""End-to-end pipeline tests: resquiggle CLI (TSV source) and trainer."""

import io
import os

import numpy as np
import pytest
import zstandard as zstd

from dynamont_jax.io.output import format_segments, rows_to_csv_bytes
from dynamont_jax.models.registry import load_model_for_pore, get_model_path
from dynamont_jax.utils.signal import hampel_filter, prepare_read_sequence

from tests.ref_oracle import run_reference
from tests.synthetic import make_read, signal_to_text

pytestmark = [pytest.mark.slow, pytest.mark.parity]


@pytest.fixture(scope="module")
def model():
    return load_model_for_pore("rna002")


def _write_tsv(path, items):
    with open(path, "w") as f:
        for rid, sig, read in items:
            f.write(f"{rid}\t{rid}\t{','.join(repr(float(x)) for x in sig)}\t{read}\n")


def _read_zst_csv(path):
    with open(path, "rb") as f:
        data = zstd.ZstdDecompressor().stream_reader(
            f, read_across_frames=True
        ).read()
    lines = data.decode().strip().split("\n")
    return lines[0], [ln.split(",") for ln in lines[1:]]


def test_format_segments_semantics():
    # processing-orientation read (rna): basepos mirrored, motif reversed
    read = "AAACGTACG"
    segs = [("M", 2, 0, 1.0), ("M", 3, 2, 1.0), ("M", 4, 871, 0.895648)]
    rows = format_segments(segs, 10, 1000, read, 5, rna=True)
    # first row: start=10, end=2+10, basepos mirrored: len-2-1=6, base read[2]
    assert list(rows[0])[:4] == [10, 12, 6, "A"]
    assert rows[0][4] == read[0:5][::-1]
    assert list(rows[1])[:2] == [12, 881]
    assert list(rows[2])[:2] == [881, 1000]
    assert rows[2][7] == "NA"
    # dna: no mirroring
    rows = format_segments(segs, 0, 1000, read, 5, rna=False)
    assert rows[0][2] == 2 and rows[0][4] == read[0:5]


def test_resquiggle_cli_tsv_basic(model, tmp_path):
    """TSV -> basic mode -> zstd CSV; rows must match the reference binary's
    segmentation formatted through the same output conventions."""
    from dynamont_jax.cli import resquiggle

    items = []
    for s in range(3):
        sig, read_proc = make_read(model, n_bases=40, seed=40 + s)
        # strip the polyA prefix/reversal: TSV carries the 5'->3' basecall
        read_53 = read_proc[9:][::-1]
        items.append((f"read{s}", sig, read_53))
    tsv = tmp_path / "reads.tsv"
    _write_tsv(tsv, items)
    out = tmp_path / "out.csv.zst"
    resquiggle.main([
        "--tsv", str(tsv), "-o", str(out), "--mode", "basic", "-p", "rna002",
    ])
    header, rows = _read_zst_csv(out)
    assert header == "readid,signalid,start,end,basepos,base,motif,state,posterior_probability,polish"
    assert {r[0] for r in rows} == {"read0", "read1", "read2"}
    err_file = tmp_path / "out.errors"
    assert not err_file.exists()

    # oracle comparison for read0 through the same host preprocessing
    sig = items[0][1].copy()
    hampel_filter(sig)
    read_proc = prepare_read_sequence(items[0][2], rna=True)
    p = run_reference("dynamont-NT-banded", signal_to_text(sig), read_proc)
    assert p.returncode == 0, p.stderr
    ref_segs = []
    for part in p.stdout.strip().split(";"):
        if part:
            f = part[1:].split(",")
            ref_segs.append(("M", int(f[0]), int(f[1]), float(f[2])))
    ref_rows = format_segments(ref_segs, 0, len(sig), read_proc, 5, rna=True)
    got_rows = [r for r in rows if r[0] == "read0"]
    assert len(got_rows) == len(ref_rows)
    for got, want in zip(got_rows, ref_rows):
        # columns: readid,signalid,start,end,basepos,base,motif,state,prob,polish
        assert got[2:8] == [str(x) for x in want[:6]]
        assert abs(float(got[8]) - float(want[6])) < 2e-3
        assert got[9] == str(want[7])


def test_resquiggle_cli_resume(model, tmp_path):
    """--resume skips already-segmented reads and appends a new zstd frame;
    the final CSV matches a single-shot run line-for-line."""
    from dynamont_jax.cli import resquiggle

    items = []
    for s in range(3):
        sig, read_proc = make_read(model, n_bases=40, seed=80 + s)
        items.append((f"read{s}", sig, read_proc[9:][::-1]))
    tsv_all = tmp_path / "all.tsv"
    tsv_part = tmp_path / "part.tsv"
    _write_tsv(tsv_all, items)
    _write_tsv(tsv_part, items[:2])

    ref_out = tmp_path / "ref.csv.zst"
    resquiggle.main([
        "--tsv", str(tsv_all), "-o", str(ref_out), "--mode", "basic",
        "-p", "rna002",
    ])
    out = tmp_path / "out.csv.zst"
    resquiggle.main([
        "--tsv", str(tsv_part), "-o", str(out), "--mode", "basic",
        "-p", "rna002",
    ])
    resquiggle.main([
        "--tsv", str(tsv_all), "-o", str(out), "--mode", "basic",
        "-p", "rna002", "--resume",
    ])
    h_ref, rows_ref = _read_zst_csv(ref_out)
    h_got, rows_got = _read_zst_csv(out)
    assert h_got == h_ref
    assert sorted(map(tuple, rows_got)) == sorted(map(tuple, rows_ref))


def test_resquiggle_cli_resume_after_truncation(model, tmp_path):
    """A hard kill leaves a truncated zstd frame; --resume must repair the
    file (drop the possibly-partial trailing read) and still produce a
    decodable CSV identical to a single-shot run."""
    from dynamont_jax.cli import resquiggle

    items = []
    for s in range(3):
        sig, read_proc = make_read(model, n_bases=40, seed=86 + s)
        items.append((f"read{s}", sig, read_proc[9:][::-1]))
    tsv_all = tmp_path / "all.tsv"
    _write_tsv(tsv_all, items)

    ref_out = tmp_path / "ref.csv.zst"
    resquiggle.main([
        "--tsv", str(tsv_all), "-o", str(ref_out), "--mode", "basic",
        "-p", "rna002",
    ])
    # simulate the kill: truncate the finished file mid-frame
    out = tmp_path / "out.csv.zst"
    data = ref_out.read_bytes()
    out.write_bytes(data[: len(data) - 7])
    resquiggle.main([
        "--tsv", str(tsv_all), "-o", str(out), "--mode", "basic",
        "-p", "rna002", "--resume",
    ])
    h_ref, rows_ref = _read_zst_csv(ref_out)
    h_got, rows_got = _read_zst_csv(out)
    assert h_got == h_ref
    assert sorted(map(tuple, rows_got)) == sorted(map(tuple, rows_ref))


def test_trainer_tsv(model, tmp_path):
    items = []
    for s in range(4):
        sig, read_proc = make_read(model, n_bases=30, seed=80 + s)
        items.append((f"tr{s}", sig, read_proc[9:][::-1]))
    tsv = tmp_path / "train.tsv"
    _write_tsv(tsv, items)
    outdir = tmp_path / "trained"
    from dynamont_jax.training.trainer import Trainer
    from dynamont_jax.io import readers
    from dynamont_jax.utils.kmer import int2kmer
    from dynamont_jax.utils.pore_model import write_kmer_models

    # the trainer reads a TSV kmer model; build one from the packaged npz
    # in 5'->3' storage order (reverse processing-orientation kmers)
    model_tsv = tmp_path / "init.model"
    models = {}
    for k in range(model.num_kmers):
        kmer = int2kmer(k, model.alphabet_size, model.kmer_size, model.rna)
        models[kmer] = (float(model.means[k]), float(model.stdevs[k]))
    write_kmer_models(model_tsv, models)

    trainer = Trainer("basic", "rna002", str(outdir), str(model_tsv), batch_size=4)
    jobs = list(readers.generate_tsv_jobs(str(tsv), rna=True))
    dz = trainer.process_batch(jobs, epoch=0)
    trainer.close()
    assert dz is not None
    assert (outdir / "trained_0_1.model").exists()
    csv_lines = open(outdir / "params.csv").read().strip().splitlines()
    assert csv_lines[0].startswith("epoch,batch,read,")
    assert len(csv_lines) == 2
    # transition params moved off their init values but stay probabilities
    assert 0 < trainer.transition_params["m1"] < 1
    assert 0 < trainer.transition_params["e2"] < 1

    # resume picks up the checkpoint, batch counter, and transitions, and
    # appends to params.csv instead of rewriting it
    resumed = Trainer("basic", "rna002", str(outdir), str(model_tsv),
                      batch_size=4, resume=True)
    assert resumed.batch_num == 1
    assert resumed.resume_epoch == 0
    assert resumed.resume_skip_batches == 1
    assert resumed.reads_done == trainer.reads_done
    assert resumed.transition_params["m1"] == trainer.transition_params["m1"]
    assert resumed.ckpt_path.endswith("trained_0_1.model")
    dz2 = resumed.process_batch(jobs, epoch=0)
    resumed.close()
    assert dz2 is not None
    assert (outdir / "trained_0_2.model").exists()
    csv_lines = open(outdir / "params.csv").read().strip().splitlines()
    assert len(csv_lines) == 3 and csv_lines[0].startswith("epoch,batch,")
    assert csv_lines[2].startswith("0,2,")


def test_resquiggle_cli_tsv_ntc_mode(model, tmp_path):
    """TSV -> resquiggle (NTC) mode -> zstd CSV with polish column filled."""
    from dynamont_jax.cli import resquiggle

    items = []
    for s in range(2):
        sig, read_proc = make_read(model, n_bases=20, seed=60 + s)
        items.append((f"ntc{s}", sig, read_proc[9:][::-1]))
    tsv = tmp_path / "reads.tsv"
    _write_tsv(tsv, items)
    out = tmp_path / "out.csv.zst"
    resquiggle.main([
        "--tsv", str(tsv), "-o", str(out), "--mode", "resquiggle", "-p", "rna002",
    ])
    header, rows = _read_zst_csv(out)
    assert {r[0] for r in rows} == {"ntc0", "ntc1"}
    polish = {r[9] for r in rows}
    assert polish - {"NA"}, "polish column should contain k-mers"
    states = {r[7] for r in rows}
    assert states <= {"M", "P"}


def test_trainer_batched_equals_per_read(model, tmp_path):
    """The batched banded training path must produce the same parameter
    updates as the per-read path."""
    from dynamont_jax.io import readers
    from dynamont_jax.training.trainer import Trainer
    from dynamont_jax.utils.kmer import int2kmer
    from dynamont_jax.utils.pore_model import write_kmer_models

    items = []
    for s in range(3):
        sig, read_proc = make_read(model, n_bases=25, seed=90 + s)
        items.append((f"eq{s}", sig, read_proc[9:][::-1]))
    tsv = tmp_path / "eq.tsv"
    _write_tsv(tsv, items)
    model_tsv = tmp_path / "init.model"
    models = {}
    for k in range(model.num_kmers):
        kmer = int2kmer(k, model.alphabet_size, model.kmer_size, model.rna)
        models[kmer] = (float(model.means[k]), float(model.stdevs[k]))
    write_kmer_models(model_tsv, models)
    jobs = list(readers.generate_tsv_jobs(str(tsv), rna=True))

    t1 = Trainer("basic", "rna002", str(tmp_path / "a"), str(model_tsv), batch_size=3)
    t1.process_batch(jobs, epoch=0)
    t2 = Trainer("basic", "rna002", str(tmp_path / "b"), str(model_tsv), batch_size=3)

    def per_read(jobs):
        from dynamont_jax.models.nt_banded import run_nt_banded
        from dynamont_jax.utils.pore_model import pore_model_from_dict

        m = pore_model_from_dict(t2.kmer_models, t2.rna)
        out = []
        for job in jobs:
            res = run_nt_banded(job.signal, job.read, m, "rna002",
                                t2.transition_params, mode="train",
                                validate=False)
            out.append((res.trained_transitions, res.trained_emissions,
                        res.Z))
        return out

    t2._train_batch_basic = per_read
    t2.process_batch(jobs, epoch=0)
    for p in t1.transition_params:
        assert t1.transition_params[p] == pytest.approx(
            t2.transition_params[p], rel=1e-9
        ), p
    assert set(t1.kmer_models) == set(t2.kmer_models)
    diffs = [
        abs(t1.kmer_models[k][0] - t2.kmer_models[k][0])
        for k in t1.kmer_models
    ]
    assert max(diffs) < 1e-9
