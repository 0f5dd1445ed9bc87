import numpy as np
import pytest

from dynamont_jax.models.registry import get_model_path, load_model_for_pore
from dynamont_jax.utils.kmer import kmer2int
from dynamont_jax.utils.pore_model import (
    load_pore_model,
    pore_model_from_dict,
    read_kmer_models,
    reduce_9mer_to_5mer,
    save_pore_model_npz,
    write_kmer_models,
)


def _toy_tsv(tmp_path):
    path = tmp_path / "toy.model"
    lines = ["kmer\tlevel_mean\tlevel_stdv"]
    from itertools import product

    for i, kmer in enumerate("".join(p) for p in product("ACGT", repeat=3)):
        lines.append(f"{kmer}\t{i / 10.0}\t0.25")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_load_tsv_dna(tmp_path):
    model = load_pore_model(_toy_tsv(tmp_path), rna=False)
    assert model.kmer_size == 3
    assert model.alphabet_size == 4
    assert model.num_kmers == 64
    # row i was written for the i-th lexicographic kmer -> index i for DNA
    assert model.means[kmer2int("ACG", 4)] == pytest.approx(kmer2int("ACG", 4) / 10.0 * 0 + 0.6)


def test_rna_reversal(tmp_path):
    path = _toy_tsv(tmp_path)
    dna = load_pore_model(path, rna=False)
    rna = load_pore_model(path, rna=True)
    # RNA indexes by the reversed kmer (ref: utils.cpp:301-302)
    assert rna.means[kmer2int("GCA", 4)] == dna.means[kmer2int("ACG", 4)]


def test_npz_roundtrip(tmp_path):
    path = _toy_tsv(tmp_path)
    for is_rna in (False, True):
        model = load_pore_model(path, rna=is_rna)
        npz = str(tmp_path / f"toy_{is_rna}.npz")
        save_pore_model_npz(npz, model)
        back = load_pore_model(npz, rna=is_rna)
        np.testing.assert_allclose(back.means, model.means)
        np.testing.assert_allclose(back.stdevs, model.stdevs)


def test_dict_roundtrip(tmp_path):
    path = _toy_tsv(tmp_path)
    models = read_kmer_models(path)
    assert len(models) == 64
    out = str(tmp_path / "rt.model")
    write_kmer_models(out, models)
    assert read_kmer_models(out) == models
    pm = pore_model_from_dict(models, rna=False)
    ref = load_pore_model(path, rna=False)
    np.testing.assert_allclose(pm.means, ref.means)


def test_registry_packaged_rna002():
    model = load_model_for_pore("rna002")
    assert model.num_kmers == 1024
    assert model.kmer_size == 5
    assert model.rna
    # AAAAA is palindromic under reversal: spot value from the published table
    assert model.means[kmer2int("AAAAA", 4)] == pytest.approx(0.9087151885032654)
    assert get_model_path("rna002").endswith(".npz")


def test_registry_rna004_falls_back_to_5mer():
    model = load_model_for_pore("rna004")
    assert model.kmer_size in (5, 9)


def test_reduce_9mer_to_5mer():
    models9 = {
        "AA" + "ACGTA" + "GG": (1.0, 0.2),
        "CC" + "ACGTA" + "TT": (3.0, 0.4),
    }
    out = reduce_9mer_to_5mer(models9)
    assert out["ACGTA"] == (2.0, pytest.approx(0.3))


def test_score_params():
    model = load_model_for_pore("rna002")
    means, c1, c2 = model.score_params()
    x = 0.5
    k = 17
    expected = -0.5 * (
        1.8378770664093453
        + 2 * np.log(model.stdevs[k])
        + ((x - model.means[k]) / model.stdevs[k]) ** 2
    )
    got = c1[k] - c2[k] * (x - means[k]) ** 2
    assert got == pytest.approx(expected, rel=1e-12)


def test_9mer_to_5mer_cli(tmp_path):
    """CLI reduction round-trip (ref: models/9merTo5mer.py)."""
    import itertools

    from dynamont_jax.utils.pore_model import read_kmer_models, reduce_cli

    nine = tmp_path / "nine.model"
    with open(nine, "w") as f:
        f.write("kmer\tlevel_mean\tlevel_stdv\n")
        # two 9-mers sharing the same middle 5-mer
        f.write("AAACGTACG\t1.0\t0.1\n")
        f.write("CCACGTACT\t3.0\t0.3\n")
        f.write("GGGGGGGGG\t5.0\t0.5\n")
    out = tmp_path / "five.model"
    reduce_cli(["-i", str(nine), "-o", str(out)])
    five = read_kmer_models(str(out))
    assert five["ACGTA"] == (2.0, pytest.approx(0.2))
    assert five["GGGGG"] == (5.0, 0.5)
