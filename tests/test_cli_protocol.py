"""CLI protocol contract: exit codes and output formats
(ref: README.md:106-122 exit-code table)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from dynamont_jax.models.registry import get_model_path, load_model_for_pore

from tests.synthetic import make_read, signal_to_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODEL = get_model_path("rna002")


def _run_cli(module, stdin, extra=()):
    return subprocess.run(
        [sys.executable, "-m", module, "-m", MODEL, "-r", "rna002", *extra],
        input=stdin, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "DYNAMONT_FORCE_CPU": "1",
             "PYTHONPATH": ROOT, "HOME": os.environ.get("HOME", ROOT)},
    )


def test_missing_signal_exit_4():
    p = _run_cli("dynamont_jax.cli.nt_banded_main", "\nACGT\n")
    assert p.returncode == 4
    assert "Signal missing" in p.stderr


def test_missing_read_exit_5():
    p = _run_cli("dynamont_jax.cli.nt_banded_main", "1.0,2.0\n\n")
    assert p.returncode == 5
    assert "Read missing" in p.stderr


def test_signal_too_short_exit_10():
    p = _run_cli("dynamont_jax.cli.nt_banded_main", "1.0,2.0\nACGTACGTACGT\n")
    assert p.returncode == 10


def test_read_shorter_than_kmer_exit_11():
    p = _run_cli("dynamont_jax.cli.nt_banded_main", ",".join(["1.0"] * 50) + "\nACG\n")
    assert p.returncode == 11


def test_bad_model_path_exit_7():
    p = subprocess.run(
        [sys.executable, "-m", "dynamont_jax.cli.nt_banded_main",
         "-m", "/nonexistent.model", "-r", "rna002"],
        input="1.0\nACGTA\n", capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ROOT, "HOME": os.environ.get("HOME", ROOT)},
    )
    assert p.returncode == 7


def test_calcz_prints_number():
    model = load_model_for_pore("rna002")
    sig, read = make_read(model, n_bases=20, seed=11)
    p = _run_cli(
        "dynamont_jax.cli.nt_banded_main",
        signal_to_text(sig) + "\n" + read + "\n", extra=("-z",),
    )
    assert p.returncode == 0, p.stderr
    float(p.stdout.strip())


def test_score_segments():
    from dynamont_jax.eval.compare_tools import score_segments, score_tools

    rng = np.random.default_rng(0)
    sig = np.concatenate([rng.normal(m, 0.05, 40) for m in (0, 2, -1, 1)])
    borders = np.array([0, 40, 80, 120, 160])
    sc = score_segments(sig, borders, window=20)
    assert sc.shape == (3, 3)
    assert sc[0, 0] == pytest.approx(2.0, abs=0.1)   # median shift at 40
    rows = score_tools({"r": sig}, {"t1": {"r": borders}})
    assert rows[0] == "Tool,Score,Segment Quality"
    assert len(rows) == 1 + 3 * 3
