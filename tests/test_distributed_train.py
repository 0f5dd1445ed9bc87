"""Two-process distributed TRAINING.

dynamont-train --distributed: every process reads the same job stream,
trains the round-robin shard of each batch, merges per-read estimates
via a summed process_allgather, and pools identically everywhere —
process 0 writes the artifacts. The test runs the same workload single-
process and 2-process and asserts the params.csv rows and the final
checkpoint model are IDENTICAL (fp64 scan path: per-read estimates are
independent of batch composition, tests/test_train_batch.py).
"""

import os
import socket
import subprocess
import sys

import pytest

from dynamont_jax.models.registry import load_model_for_pore
from tests.synthetic import make_read

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DRIVER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from dynamont_jax.cli import train
train.main(sys.argv[1:])
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_tsv(tmp_path, n_reads=4):
    model = load_model_for_pore("rna002")
    rows = []
    for seed in range(n_reads):
        # n_bases=30: at 20 the polyA stub pushes seed 3 over the >=60%
        # single-nucleotide training filter and the batch never fills
        sig, read = make_read(model, n_bases=30, seed=seed)
        rows.append(
            f"read{seed}\tsig{seed}\t"
            + ",".join(f"{x:.5f}" for x in sig) + f"\t{read[::-1]}"
        )
    tsv = tmp_path / "reads.tsv"
    tsv.write_text("\n".join(rows) + "\n")
    return tsv


def _train_args(tsv, outdir):
    return ["--tsv", str(tsv), "-o", str(outdir), "-p", "rna002",
            "--mode", "basic", "--batch_size", "4", "-q", "0",
            "--precision", "fp64"]


def _params_rows(outdir):
    with open(outdir / "params.csv") as f:
        return f.read().splitlines()


@pytest.mark.slow
def test_two_process_training_matches_single_process(tmp_path):
    tsv = _write_tsv(tmp_path)

    # single-process reference run
    out1 = tmp_path / "single"
    r = subprocess.run(
        [sys.executable, "-c", DRIVER] + _train_args(tsv, out1),
        cwd=ROOT, capture_output=True, timeout=420,
        env=dict(os.environ),
    )
    assert r.returncode == 0, r.stderr.decode()[-2000:]

    # two-process distributed run, shared outdir
    out2 = tmp_path / "dist"
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(
            os.environ,
            DYNAMONT_COORDINATOR=f"127.0.0.1:{port}",
            DYNAMONT_NUM_PROCESSES="2",
            DYNAMONT_PROCESS_ID=str(pid),
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-c", DRIVER]
            + _train_args(tsv, out2) + ["--distributed"],
            env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e.decode()[-2000:]
    # each process trained only its shard (2 of 4 reads)
    err0 = outs[0][1].decode()
    assert "distributed training: process 0 of 2" in err0

    rows1 = _params_rows(out1)
    rows2 = _params_rows(out2)
    assert len(rows2) == len(rows1) >= 2
    assert rows2 == rows1  # header + per-batch params + Zchange identical

    m1 = (out1 / "trained_0_1.model").read_bytes()
    m2 = (out2 / "trained_0_1.model").read_bytes()
    assert m1 == m2
