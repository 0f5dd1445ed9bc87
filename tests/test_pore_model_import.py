"""Golden tests for the pore-model import workflow.

The packaged rna004_9mer and DNA r10.4.1 tables are git-LFS blobs absent
from both this build and the reference mount (ref force-includes them at
pyproject.toml:76-82 and getModel resolves them at FileIO.py:535-540).
The documented mitigation is `scripts/import_pore_models.py`: TSV ->
packaged .npz -> registry -> engine.  These tests make that workflow
executable evidence: a miniature (deterministic, synthetic-valued but
full-K) 9-mer TSV and a DNA r10 5-mer TSV are vendored in-test, imported
through the real script, checksummed, resolved through the registry, and
driven through an engine.
"""

import hashlib
import importlib.util
import os

import numpy as np

from dynamont_jax.models import registry
from dynamont_jax.utils.kmer import int2kmer, kmer2int
from dynamont_jax.utils.pore_model import load_pore_model
from dynamont_jax.utils.synthetic import make_read


def _import_script():
    """Load scripts/import_pore_models.py as a module (it is a script,
    not part of the package)."""
    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        "import_pore_models.py")
    spec = importlib.util.spec_from_file_location("import_pore_models", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _golden_tables(K: int, seed: int):
    """Deterministic per-kmer Gaussians, values keyed to the 5'->3' index."""
    rng = np.random.default_rng(seed)
    means = np.round(rng.uniform(60.0, 140.0, K), 6)
    stdevs = np.round(rng.uniform(1.0, 9.0, K), 6)
    return means, stdevs


def _write_tsv(path, means, stdevs, kmer_size):
    with open(path, "w") as w:
        w.write("kmer\tlevel_mean\tlevel_stdv\n")
        for k in range(len(means)):
            kmer = int2kmer(k, 4, kmer_size, rna=False)  # file order 5'->3'
            w.write(f"{kmer}\t{means[k]}\t{stdevs[k]}\n")


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def test_import_9mer_tsv_to_registry_golden(tmp_path):
    """Full-K 9-mer TSV -> import script -> npz -> RNA-oriented load.

    Checks the exact byte content of the imported arrays (checksum of the
    canonical npz) and the RNA reversal semantics of the registry load
    (ref: utils.cpp:301-302 reverses k-mers for RNA pores)."""
    K9 = 4 ** 9
    means, stdevs = _golden_tables(K9, seed=1234)
    src = tmp_path / "rna004_9mer.model"
    dst = tmp_path / "rna004_9mer.npz"
    _write_tsv(src, means, stdevs, kmer_size=9)

    mod = _import_script()
    mod.convert(str(src), str(dst))

    # npz stores canonical 5'->3' index order: byte-for-byte the TSV values
    with np.load(dst) as z:
        assert int(z["kmer_size"]) == 9 and int(z["alphabet_size"]) == 4
        assert _sha256(z["means"]) == _sha256(means)
        assert _sha256(z["stdevs"]) == _sha256(stdevs)

    # registry load for an RNA pore applies the k-mer reversal permutation
    model = registry.load_model_for_pore("rna004", model_path=str(dst))
    assert model.kmer_size == 9 and model.num_kmers == K9 and model.rna
    for kmer in ("AAAAAAAAC", "ACGTACGTA", "TTTGGGCCC"):
        src_idx = kmer2int(kmer, 4)              # 5'->3' file order
        dst_idx = kmer2int(kmer[::-1], 4)        # 3'->5' processing order
        assert model.means[dst_idx] == means[src_idx]
        assert model.stdevs[dst_idx] == stdevs[src_idx]

    # the TSV parsed directly (rna=True) must agree with the npz round-trip
    direct = load_pore_model(str(src), rna=True)
    assert _sha256(direct.means) == _sha256(model.means)
    assert _sha256(direct.stdevs) == _sha256(model.stdevs)


def test_import_dna_r10_registry_resolution_and_engine(tmp_path, monkeypatch):
    """DNA r10 5-mer TSV -> import script -> packaged location -> registry
    default resolution (no --model_path) -> NT engine run on a synthetic
    read.  DNA loads apply NO reversal (ref: FileIO.py:535-540 getModel +
    utils.cpp:259-316)."""
    K5 = 4 ** 5
    means, stdevs = _golden_tables(K5, seed=77)
    root = tmp_path / "models"
    rel = "dna/r10.4.1/dna_r10.4.1_e8.2_400bps.model"
    src = root / rel
    src.parent.mkdir(parents=True)
    _write_tsv(src, means, stdevs, kmer_size=5)

    # import into a temp packaged dir laid out like models_data/, then
    # point the registry at it — the same KNOWN-relative-path mapping the
    # script's --all mode uses against a dynamont-style models/ tree
    out_dir = tmp_path / "models_data"
    out_dir.mkdir()
    mod = _import_script()
    assert rel in mod.KNOWN and mod.KNOWN[rel] == "dna_r10.4.1_e8.2_400bps.npz"
    mod.convert(str(src), str(out_dir / mod.KNOWN[rel]))
    monkeypatch.setattr(registry, "_DATA_DIR", str(out_dir))

    path = registry.get_model_path("dna_r10_400bps")
    assert path.endswith("dna_r10.4.1_e8.2_400bps.npz")
    model = registry.load_model_for_pore("dna_r10_400bps")
    assert model.kmer_size == 5 and not model.rna
    for kmer in ("AAAAA", "ACGTC", "TGCAT"):
        idx = kmer2int(kmer, 4)
        assert model.means[idx] == means[idx]

    # engine load: the resolved model drives a full NT segmentation
    from dynamont_jax.models.nt import run_nt

    sig, read = make_read(model, n_bases=24, seed=3)
    res = run_nt(sig, read, model, "dna_r10_400bps")
    assert res.segments is not None and len(res.segments) > 0


def test_import_9mer_engine_load(tmp_path):
    """The imported 9-mer npz drives the native big-K NTC engine's model
    load path (K=4^9 tables through registry -> PoreModel -> score
    tables), guarding the documented --ntc-native-9mer workflow."""
    K9 = 4 ** 9
    means, stdevs = _golden_tables(K9, seed=9)
    src = tmp_path / "m.model"
    dst = tmp_path / "m.npz"
    _write_tsv(src, means, stdevs, kmer_size=9)
    _import_script().convert(str(src), str(dst))
    model = registry.load_model_for_pore("rna004", model_path=str(dst))
    mu, c1, c2 = model.score_params()
    assert mu.shape == (K9,) and np.all(np.isfinite(c1))
