"""DNA pore path (no RNA reversal, no polyA prefix) vs the reference binary."""

import numpy as np
import pytest

from dynamont_jax.models.nt_banded import run_nt_banded
from dynamont_jax.utils.pore_model import pore_model_from_dict
from dynamont_jax.utils.kmer import int2kmer, seq_to_kmer_ids

from tests.synthetic import signal_to_text

pytestmark = [pytest.mark.parity]


@pytest.fixture(scope="module")
def dna_model(tmp_path_factory):
    """Synthetic 5-mer DNA model written as TSV for the oracle binary."""
    rng = np.random.default_rng(42)
    models = {}
    for k in range(4 ** 5):
        kmer = int2kmer(k, 4, 5, rna=False)
        models[kmer] = (float(rng.normal(0, 1)), 0.2)
    path = tmp_path_factory.mktemp("dna") / "dna5.model"
    from dynamont_jax.utils.pore_model import write_kmer_models

    write_kmer_models(path, models)
    return pore_model_from_dict(models, rna=False), str(path)


def _make_dna_read(model, n_bases, seed):
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list("ACGT"), size=n_bases))
    kids = seq_to_kmer_ids(seq, 5, 4)
    sig = []
    for k in kids:
        d = max(2, rng.poisson(9))
        sig.append(rng.normal(model.means[k], model.stdevs[k], size=d))
    return np.concatenate(sig), seq


def test_dna_r9_banded_matches_reference(dna_model):
    model, model_path = dna_model
    sig, read = _make_dna_read(model, 40, seed=7)
    # call the binary directly with -r dna_r9 (run_reference hardcodes rna002)
    import subprocess

    from tests.ref_oracle import reference_binary

    p = subprocess.run(
        [reference_binary("dynamont-NT-banded"), "-m", model_path, "-r", "dna_r9"],
        input=signal_to_text(sig) + "\n" + read + "\n",
        capture_output=True, text=True,
    )
    assert p.returncode == 0, p.stderr
    ref = [s.split(",") for s in p.stdout.strip().split(";") if s]
    res = run_nt_banded(sig, read, model, "dna_r9")
    assert len(res.segments) == len(ref)
    for got, want in zip(res.segments, ref):
        assert got[1] == int(want[0][1:])
        assert got[2] == int(want[1])
        assert got[3] == pytest.approx(float(want[2]), abs=1e-5)
