"""NTC resquiggle mode: invariants + parity vs the reference dynamont-NTC."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from dynamont_jax.models.ntc import run_ntc
from dynamont_jax.models.registry import load_model_for_pore
from dynamont_jax.ops import ntc_pre

from tests.ref_oracle import run_reference
from tests.synthetic import make_read, signal_to_text

pytestmark = [pytest.mark.slow, pytest.mark.parity]


@pytest.fixture(scope="module")
def model():
    return load_model_for_pore("rna002")


def test_tk_prepass_z_consistency(model):
    """Forward/backward Z equality for the TK pre-pass (mirrors the
    reference gtest invariant, ref: test/test.cpp:471-521)."""
    sig, read = make_read(model, n_bases=30, seed=1)
    means, c1, c2 = model.score_params()
    log_m = math.log(0.019889650396799997)
    log_e = math.log(0.9801103496029998)
    pk = ntc_pre.pre_tk(
        jnp.asarray(sig, jnp.float64), jnp.asarray(means), jnp.asarray(c1),
        jnp.asarray(c2), log_m, log_e, model.alphabet_size, cap=16,
    )
    assert float(pk.Zf) == pytest.approx(float(pk.Zb), abs=1e-6)


def test_tn_prepass_z_consistency(model):
    from dynamont_jax.ops import nt_full
    from dynamont_jax.utils.kmer import seq_to_kmer_ids

    sig, read = make_read(model, n_bases=30, seed=2)
    kid = seq_to_kmer_ids(read, model.kmer_size, model.alphabet_size)
    scores = nt_full.emission_scores(sig, kid, model.means, model.stdevs, jnp.float64)
    pn = ntc_pre.pre_tn(
        scores, math.log(0.019889650396799997), math.log(0.9801103496029998), cap=8
    )
    assert float(pn.Zf) == pytest.approx(float(pn.Zb), abs=1e-6)


def test_ntc_z_matches_reference(model):
    """End-to-end Z parity vs dynamont-NTC --calcZ: exercises both
    pre-passes, the candidate selection, and the 5-state 3D DP."""
    for seed in (0, 1):
        sig, read = make_read(model, n_bases=25, seed=seed)
        p = run_reference(
            "dynamont-NTC", signal_to_text(sig), read, extra_args=("-z",)
        )
        assert p.returncode == 0, p.stderr
        ref_z = float(p.stdout.strip())
        res = run_ntc(sig, read, model, "rna002", mode="calcZ")
        assert res.Z == pytest.approx(ref_z, rel=1e-9), f"seed={seed}"
