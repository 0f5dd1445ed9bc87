"""NTC Baum-Welch training parity vs dynamont-NTC --train."""

import pytest

from dynamont_jax.models.ntc import run_ntc
from dynamont_jax.models.registry import load_model_for_pore

from tests.ref_oracle import run_reference
from tests.synthetic import make_read, signal_to_text

pytestmark = [pytest.mark.slow, pytest.mark.parity]


@pytest.fixture(scope="module")
def model():
    return load_model_for_pore("rna002")


def test_ntc_train_matches_reference(model):
    sig, read = make_read(model, n_bases=25, seed=3)
    p = run_reference(
        "dynamont-NTC", signal_to_text(sig), read, extra_args=("--train",)
    )
    assert p.returncode == 0, p.stderr
    lines = p.stdout.strip().splitlines()
    # line 1: transitions "a1:v;a2:v;..."; line 2: kmer:mean,stdev;...; line 3: Z:v
    ref_trans = {}
    for kv in lines[0].split(";"):
        if kv:
            k, v = kv.split(":")
            ref_trans[k] = float(v)
    ref_emis = {}
    for kv in lines[1].split(";"):
        if kv:
            kmer, mv = kv.split(":")
            m, s = mv.split(",")
            ref_emis[kmer] = (float(m), float(s))
    ref_z = float(lines[2].split(":")[1])

    res = run_ntc(sig, read, model, "rna002", mode="train")
    assert res.Z == pytest.approx(ref_z, rel=1e-9)
    for k, v in ref_trans.items():
        assert res.trained_transitions[k] == pytest.approx(v, rel=1e-5, abs=1e-9), k
    assert set(res.trained_emissions) == set(ref_emis)
    for kmer, (m, s) in ref_emis.items():
        got = res.trained_emissions[kmer]
        assert got[0] == pytest.approx(m, rel=1e-5, abs=1e-7), kmer
        assert got[1] == pytest.approx(s, rel=1e-5, abs=1e-7), kmer
