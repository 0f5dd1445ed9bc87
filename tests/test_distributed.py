"""Two-process distributed run: jax.distributed bring-up + round-robin job
sharding with .rank<k> outputs (SURVEY.md §2.4/§5 distributed rows)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import zstandard as zstd

from dynamont_jax.models.registry import load_model_for_pore
from tests.synthetic import make_read

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DRIVER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from dynamont_jax.cli import resquiggle
resquiggle.main(sys.argv[1:])
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_distributed_required_fails_loudly(monkeypatch):
    """required=True must surface bring-up failures instead of silently
    degrading to a single-process run (a real dead coordinator aborts in
    native code, so the failure is injected at the jax.distributed API)."""
    import jax

    from dynamont_jax.parallel.mesh import init_distributed

    calls = {}

    def boom(*a, **kw):
        calls["args"] = a
        raise ValueError("no coordinator reachable")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    monkeypatch.setenv("DYNAMONT_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("DYNAMONT_NUM_PROCESSES", "2")
    monkeypatch.setenv("DYNAMONT_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="distributed run requested"):
        init_distributed(required=True)
    assert calls["args"] == ("127.0.0.1:1", 2, 0)  # env vars were picked up
    # without required: degrade silently (reference-free environments)
    init_distributed(required=False)


@pytest.mark.parametrize("env,want", [(None, {}),
                                      ("2", {"local_device_ids": [2]})])
def test_init_distributed_one_card_per_process(monkeypatch, env, want):
    """Processes sharing a multi-card host each open only their own card
    (DYNAMONT_LOCAL_DEVICE); without it every process sees all cards."""
    import jax

    from dynamont_jax.parallel.mesh import init_distributed

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda *a, **kw: seen.update(args=a, kw=kw))
    monkeypatch.setenv("DYNAMONT_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("DYNAMONT_NUM_PROCESSES", "4")
    monkeypatch.setenv("DYNAMONT_PROCESS_ID", "2")
    if env is None:
        monkeypatch.delenv("DYNAMONT_LOCAL_DEVICE", raising=False)
    else:
        monkeypatch.setenv("DYNAMONT_LOCAL_DEVICE", env)
    init_distributed(required=True)
    assert seen["args"] == ("localhost:1234", 4, 2)
    assert seen["kw"] == want


@pytest.mark.slow
def test_two_process_resquiggle_partitions_reads(tmp_path):
    model = load_model_for_pore("rna002")
    rows = []
    for seed in range(4):
        sig, read = make_read(model, n_bases=20, seed=seed)
        rows.append(
            f"read{seed}\tsig{seed}\t"
            + ",".join(f"{x:.5f}" for x in sig) + f"\t{read[::-1]}"
        )
    tsv = tmp_path / "reads.tsv"
    tsv.write_text("\n".join(rows) + "\n")
    out = tmp_path / "out.csv.zst"

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
            [sys.executable, "-c", DRIVER, "--tsv", str(tsv), "-o", str(out),
             "--mode", "basic", "-p", "rna002", "--distributed"],
            env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e.decode()[-2000:]

    seen = {}
    for rank in range(2):
        path = tmp_path / f"out.csv.zst.rank{rank}"
        assert path.exists()
        text = zstd.ZstdDecompressor().stream_reader(
            path.open("rb")).read().decode()
        rids = {ln.split(",")[0] for ln in text.strip().splitlines()[1:]}
        seen[rank] = rids
    # round-robin partition: rank0 gets even job indices, rank1 odd
    assert seen[0] == {"read0", "read2"}
    assert seen[1] == {"read1", "read3"}
