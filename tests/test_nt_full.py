import math

import numpy as np
import pytest

from dynamont_jax.models.registry import load_model_for_pore
from dynamont_jax.models.nt import run_nt, ZConsistencyError
from dynamont_jax.ops import nt_full
from dynamont_jax.utils.kmer import seq_to_kmer_ids
from dynamont_jax.utils.output import segments_to_string
from tests.ref_oracle import run_reference, REF_MODEL_RNA002

from tests.synthetic import make_read, signal_to_text

MODEL = load_model_for_pore("rna002")


def _mats(seed=1, n_bases=30):
    sig, read = make_read(MODEL, n_bases=n_bases, seed=seed)
    kmer_ids = seq_to_kmer_ids(read, MODEL.kmer_size, MODEL.alphabet_size)
    scores = nt_full.emission_scores(sig, kmer_ids, MODEL.means, MODEL.stdevs)
    from dynamont_jax.constants import NT_TRANSITIONS

    t = NT_TRANSITIONS["rna002"]
    return sig, read, scores, nt_full.nt_forward_backward(scores, t["m1"], t["e2"])


def test_z_consistency():
    sig, read, scores, mats = _mats()
    T, N = mats.forM.shape
    assert nt_full.check_z(mats.Zf, mats.Zb, T * N)
    assert abs(float(mats.Zf) - float(mats.Zb)) < 1e-6


def test_posterior_rows_sum_to_one():
    _, _, _, mats = _mats(seed=3)
    LPM, LPE = nt_full.posterior_matrices(mats)
    total = np.logaddexp(np.asarray(LPM), np.asarray(LPE))
    # each signal sample t>=1 is explained by exactly one state/kmer cell
    row = np.asarray([np.logaddexp.reduce(r) for r in total[1:]])
    np.testing.assert_allclose(row, 0.0, atol=1e-9)


def test_upper_triangle_is_impossible():
    _, _, _, mats = _mats(seed=4)
    forE = np.asarray(mats.forE)
    T, N = forE.shape
    for n in range(1, min(N, 12)):
        assert np.all(np.isinf(forE[: n, n])), "cells with n > t must be -inf"


@pytest.mark.parity
@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_segment_string_matches_reference(seed):
    sig, read = make_read(MODEL, n_bases=35, seed=seed)
    res = run_nt(sig, read, MODEL, "rna002", mode="segment")
    ref = run_reference("dynamont-NT", signal_to_text(sig), read)
    assert ref.returncode == 0, ref.stderr
    assert segments_to_string(res.segments) == ref.stdout.strip()


@pytest.mark.parity
def test_calcz_matches_reference():
    sig, read = make_read(MODEL, n_bases=35, seed=11)
    res = run_nt(sig, read, MODEL, "rna002", mode="calcZ")
    ref = run_reference("dynamont-NT", signal_to_text(sig), read, ["--calcZ"])
    assert ref.returncode == 0, ref.stderr
    assert res.Z == pytest.approx(float(ref.stdout.strip()), abs=1e-7)


@pytest.mark.parity
def test_train_matches_reference():
    sig, read = make_read(MODEL, n_bases=35, seed=12)
    res = run_nt(sig, read, MODEL, "rna002", mode="train")
    ref = run_reference("dynamont-NT", signal_to_text(sig), read, ["--train"])
    assert ref.returncode == 0, ref.stderr
    trans_line, model_line, z_line = ref.stdout.strip().split("\n")
    ref_trans = {p.split(":")[0]: float(p.split(":")[1]) for p in trans_line.split(";")}
    for k in ("m1", "e1", "e2"):
        assert res.trained_transitions[k] == pytest.approx(ref_trans[k], abs=1e-9)
    ref_models = {
        p.split(":")[0]: tuple(map(float, p.split(":")[1].split(",")))
        for p in model_line.split(";")[:-1]
    }
    assert set(res.trained_emissions) == set(ref_models)
    for kmer, (m, s) in ref_models.items():
        assert res.trained_emissions[kmer][0] == pytest.approx(m, abs=1e-8)
        assert res.trained_emissions[kmer][1] == pytest.approx(s, abs=1e-8)
    assert res.Z == pytest.approx(float(z_line.split(":")[1]), abs=1e-7)


@pytest.mark.parity
def test_prob_output_matches_reference():
    sig, read = make_read(MODEL, n_bases=30, seed=13)
    res = run_nt(sig, read, MODEL, "rna002", mode="segment", want_prob=True)
    ref = run_reference("dynamont-NT", signal_to_text(sig), read, ["-p"])
    assert ref.returncode == 0, ref.stderr
    seg_line, prob_line = ref.stdout.strip().split("\n")
    ref_probs = np.array([float(x) for x in prob_line.split(",")[:-1]])
    np.testing.assert_allclose(res.per_t_logprob, ref_probs, atol=1e-7)


def test_cli_protocol(tmp_path, capsys, monkeypatch):
    import io
    import sys

    from dynamont_jax.cli import nt_main

    sig, read = make_read(MODEL, n_bases=30, seed=21)
    stdin = io.StringIO(signal_to_text(sig) + "\n" + read + "\n")
    monkeypatch.setattr(sys, "stdin", stdin)
    monkeypatch.setenv("DYNAMONT_FORCE_CPU", "1")
    from dynamont_jax.models.registry import get_model_path

    nt_main.main(["-m", get_model_path("rna002"), "-r", "rna002"])
    out = capsys.readouterr().out.strip()
    assert out.startswith("M")
    assert out.endswith(";")


def test_cli_missing_signal(monkeypatch, capsys):
    import io
    import sys

    from dynamont_jax.cli import nt_main
    from dynamont_jax.models.registry import get_model_path

    monkeypatch.setattr(sys, "stdin", io.StringIO("\n\n"))
    with pytest.raises(SystemExit) as e:
        nt_main.main(["-m", get_model_path("rna002"), "-r", "rna002"])
    assert e.value.code == 4


def test_cli_bad_model_path():
    from dynamont_jax.cli import nt_main

    with pytest.raises(SystemExit) as e:
        nt_main.main(["-m", "/nonexistent.model", "-r", "rna002"])
    assert e.value.code == 7


def test_input_validation_exit_codes():
    # signal shorter than 2*read -> exit 10 (ref: utils.cpp:542-546)
    sig = np.ones(5)
    with pytest.raises(SystemExit) as e:
        run_nt(sig, "ACGTACGTAC", MODEL, "rna002")
    assert e.value.code == 10
    # read shorter than kmer size -> exit 11
    with pytest.raises(SystemExit) as e:
        run_nt(np.ones(50), "ACG", MODEL, "rna002")
    assert e.value.code == 11
