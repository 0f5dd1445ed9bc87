import numpy as np
import pytest

from dynamont_jax.models.registry import load_model_for_pore
from dynamont_jax.models.nt import run_nt
from dynamont_jax.models.nt_banded import run_nt_banded
from dynamont_jax.ops.geometry import band_geometry, effective_bandwidth
from dynamont_jax.utils.output import segments_to_string
from tests.ref_oracle import run_reference
from tests.synthetic import make_read, signal_to_text

MODEL = load_model_for_pore("rna002")


def test_geometry_matches_reference_semantics():
    geom = band_geometry(T=100, N=20, bandwidth=5)
    assert geom.B == 13
    # t=0: midpoint 0, bstart -5
    assert geom.bstart[0] == -5
    assert geom.n_start[0] == 0
    assert geom.n_end[0] == 6
    # last row touches N-1
    assert geom.n_end[-1] == 20
    # shifts are 0/1 and sum to total band movement
    assert geom.shift[0] == False  # noqa: E712
    assert (geom.bstart[1:] - geom.bstart[:-1]).max() <= 1
    assert geom.bstart[-1] + geom.bandwidth == 19  # midpoint(T-1) = N-1


def test_effective_bandwidth():
    assert effective_bandwidth(400, 1000) == 200
    assert effective_bandwidth(400, 100) == 50


def test_banded_z_consistency_and_vs_full():
    sig, read = make_read(MODEL, n_bases=40, seed=31)
    full = run_nt(sig, read, MODEL, "rna002", mode="calcZ")
    banded = run_nt_banded(sig, read, MODEL, "rna002", mode="calcZ", band=400)
    # generous band on a clean synthetic read: banded Z ~ full Z
    assert banded.Z == pytest.approx(full.Z, abs=1e-6)


def test_banded_segments_match_full_generous_band():
    sig, read = make_read(MODEL, n_bases=40, seed=32)
    full = run_nt(sig, read, MODEL, "rna002", mode="segment")
    banded = run_nt_banded(sig, read, MODEL, "rna002", mode="segment", band=4000)
    assert segments_to_string(full.segments) == segments_to_string(banded.segments)


@pytest.mark.parity
@pytest.mark.parametrize("seed,band", [(41, 400), (42, 400), (43, 50), (44, 16)])
def test_banded_matches_reference(seed, band):
    sig, read = make_read(MODEL, n_bases=50, seed=seed)
    res = run_nt_banded(sig, read, MODEL, "rna002", mode="segment", band=band)
    ref = run_reference("dynamont-NT-banded", signal_to_text(sig), read, ["-b", str(band)])
    assert ref.returncode == 0, ref.stderr
    assert segments_to_string(res.segments) == ref.stdout.strip()


@pytest.mark.parity
def test_banded_calcz_matches_reference():
    sig, read = make_read(MODEL, n_bases=50, seed=45)
    res = run_nt_banded(sig, read, MODEL, "rna002", mode="calcZ")
    ref = run_reference("dynamont-NT-banded", signal_to_text(sig), read, ["--calcZ"])
    assert ref.returncode == 0, ref.stderr
    assert res.Z == pytest.approx(float(ref.stdout.strip()), abs=1e-7)


@pytest.mark.parity
def test_banded_train_matches_reference():
    sig, read = make_read(MODEL, n_bases=40, seed=46)
    res = run_nt_banded(sig, read, MODEL, "rna002", mode="train")
    ref = run_reference("dynamont-NT-banded", signal_to_text(sig), read, ["--train"])
    assert ref.returncode == 0, ref.stderr
    trans_line, model_line, z_line = ref.stdout.strip().split("\n")
    ref_trans = {x.split(":")[0]: float(x.split(":")[1]) for x in trans_line.split(";")}
    for k in ("m1", "e1", "e2"):
        assert res.trained_transitions[k] == pytest.approx(ref_trans[k], abs=1e-9)
    ref_models = {
        x.split(":")[0]: tuple(map(float, x.split(":")[1].split(",")))
        for x in model_line.split(";")[:-1]
    }
    assert set(res.trained_emissions) == set(ref_models)
    for kmer, (m, s) in ref_models.items():
        assert res.trained_emissions[kmer][0] == pytest.approx(m, abs=1e-8)
        assert res.trained_emissions[kmer][1] == pytest.approx(s, abs=1e-8)
    assert res.Z == pytest.approx(float(z_line.split(":")[1]), abs=1e-7)


@pytest.mark.parity
def test_banded_prob_matches_reference():
    sig, read = make_read(MODEL, n_bases=40, seed=47)
    res = run_nt_banded(sig, read, MODEL, "rna002", mode="segment", want_prob=True)
    ref = run_reference("dynamont-NT-banded", signal_to_text(sig), read, ["-p"])
    assert ref.returncode == 0, ref.stderr
    _, prob_line = ref.stdout.strip().split("\n")
    ref_probs = np.array([float(x) for x in prob_line.split(",")[:-1]])
    np.testing.assert_allclose(res.per_t_logprob, ref_probs, atol=1e-7)


@pytest.mark.parity
def test_banded_long_read_parity():
    # longer read exercising band shifts over many steps
    sig, read = make_read(MODEL, n_bases=200, mean_dwell=12.0, seed=48)
    res = run_nt_banded(sig, read, MODEL, "rna002", mode="segment", band=400)
    ref = run_reference("dynamont-NT-banded", signal_to_text(sig), read)
    assert ref.returncode == 0, ref.stderr
    assert segments_to_string(res.segments) == ref.stdout.strip()
