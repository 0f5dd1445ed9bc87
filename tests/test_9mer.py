"""9-mer pore support end-to-end (rna004 / dna_r10 flavors).

The real 9-mer tables are git-LFS blobs absent from this environment (and
from the reference mount), so these tests synthesize 9-mer models, write
them as reference-format TSVs, and check parity against the reference
binaries plus the documented NTC 5-mer-reduction fallback
(ref: NTC_main.cpp:95-99 K=4^9; models/9merTo5mer.py).
"""

import subprocess

import numpy as np
import pytest

from dynamont_jax.utils.kmer import int2kmer, seq_to_kmer_ids
from dynamont_jax.utils.pore_model import (
    load_pore_model, reduce_model_to_5mer, write_kmer_models,
)

from tests.synthetic import signal_to_text

pytestmark = [pytest.mark.slow, pytest.mark.parity]

K9 = 4 ** 9


def _write_9mer_tsv(path, seed):
    """Random 9-mer Gaussian table in reference TSV format (5'->3')."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-2.0, 2.0, K9)
    stdevs = rng.uniform(0.15, 0.4, K9)
    with open(path, "w") as w:
        w.write("kmer\tlevel_mean\tlevel_stdv\n")
        for k in range(K9):
            kmer = int2kmer(k, 4, 9, rna=False)  # file order, 5'->3'
            w.write(f"{kmer}\t{means[k]}\t{stdevs[k]}\n")
    return path


@pytest.fixture(scope="module")
def model9_rna(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("m9") / "rna9.model")
    _write_9mer_tsv(path, seed=11)
    return load_pore_model(path, rna=True), path


@pytest.fixture(scope="module")
def model9_dna(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("m9d") / "dna9.model")
    _write_9mer_tsv(path, seed=12)
    return load_pore_model(path, rna=False), path


def _make_read9(model, n_bases, seed, rna):
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list("ACGT"), size=n_bases))
    if rna:
        seq = "AAAAAAAAA" + seq  # polyA stub, processing orientation
    kids = seq_to_kmer_ids(seq, 9, 4)
    sig = []
    for k in kids:
        d = max(2, rng.poisson(8))
        sig.append(rng.normal(model.means[k], model.stdevs[k], size=d))
    return np.concatenate(sig), seq


def _ref(binary, model_path, pore, sig, read, extra=()):
    from tests.ref_oracle import reference_binary

    return subprocess.run(
        [reference_binary(binary), "-m", model_path, "-r", pore, *extra],
        input=signal_to_text(sig) + "\n" + read + "\n",
        capture_output=True, text=True,
    )


def test_rna004_9mer_banded_matches_reference(model9_rna):
    """Banded basic mode at K=4^9 (gather-only in K -> no memory blowup)."""
    from dynamont_jax.models.nt_banded import run_nt_banded

    model, path = model9_rna
    assert model.kmer_size == 9 and model.num_kmers == K9
    sig, read = _make_read9(model, 40, seed=3, rna=True)
    p = _ref("dynamont-NT-banded", path, "rna004", sig, read)
    assert p.returncode == 0, p.stderr
    ref = [s.split(",") for s in p.stdout.strip().split(";") if s]
    res = run_nt_banded(sig, read, model, "rna004")
    assert len(res.segments) == len(ref)
    for got, want in zip(res.segments, ref):
        assert got[1] == int(want[0][1:]) and got[2] == int(want[1])


def test_dna_r10_9mer_full_matches_reference(model9_dna):
    from dynamont_jax.models.nt import run_nt

    model, path = model9_dna
    sig, read = _make_read9(model, 30, seed=4, rna=False)
    p = _ref("dynamont-NT", path, "dna_r10_400bps", sig, read)
    assert p.returncode == 0, p.stderr
    ref = [s.split(",") for s in p.stdout.strip().split(";") if s]
    res = run_nt(sig, read, model, "dna_r10_400bps")
    assert len(res.segments) == len(ref)
    for got, want in zip(res.segments, ref):
        assert got[1] == int(want[0][1:]) and got[2] == int(want[1])


def test_rna004_9mer_ntc_small_matches_reference(model9_rna):
    """Per-read NTC runs 9-mers natively (dense TK pass is (T, 4^9) — only
    viable for short reads, exactly like the reference)."""
    from dynamont_jax.models.ntc import run_ntc

    model, path = model9_rna
    sig, read = _make_read9(model, 4, seed=5, rna=True)  # N=13+1, T~100
    p = _ref("dynamont-NTC", path, "rna004", sig, read)
    assert p.returncode == 0, p.stderr
    segstr = p.stdout.splitlines()[0]
    ref = []
    for part in segstr.strip().split(";"):
        if part:
            st, rest = part[0], part[1:].split(",")
            ref.append((st, int(rest[0]), int(rest[1]), float(rest[2]), rest[3]))
    res = run_ntc(sig, read, model, "rna004")
    assert len(res.segments) == len(ref)
    n_mismatch = 0
    for g, r in zip(res.segments, ref):
        # borders/polish must match; medians may shift when a ULP-level
        # near-tie resolves a different (equal-border) interior path
        assert g[0] == r[0] and g[1] == r[1] and g[2] == r[2]
        assert g[4] == r[4]  # polish 9-mers round-trip the codec
        n_mismatch += 0 if abs(g[3] - r[3]) < 1e-4 else 1
    assert n_mismatch <= max(1, len(ref) // 10), n_mismatch


def test_reduction_helper_matches_tsv_reduction(model9_rna, tmp_path):
    """In-memory reduce_model_to_5mer == TSV-level 9->5 reduction CLI."""
    from dynamont_jax.utils.pore_model import (
        read_kmer_models, reduce_9mer_to_5mer, pore_model_from_dict,
    )

    model, path = model9_rna
    red_mem = reduce_model_to_5mer(model)
    red_tsv = pore_model_from_dict(
        reduce_9mer_to_5mer(read_kmer_models(path)), rna=True
    )
    assert red_mem.kmer_size == 5
    np.testing.assert_allclose(red_mem.means, red_tsv.means, rtol=1e-12)
    np.testing.assert_allclose(red_mem.stdevs, red_tsv.stdevs, rtol=1e-12)


def test_ntc_engine_9mer_reduction_fallback(model9_rna, capsys):
    """NTCBatchEngine auto-reduces 9-mer models (documented fallback)."""
    import jax.numpy as jnp

    from dynamont_jax.models.ntc_batch import NTCBatchEngine

    model, _ = model9_rna
    eng = NTCBatchEngine(model, "rna004", dtype=jnp.float32)
    assert eng.model.kmer_size == 5
    red = reduce_model_to_5mer(model)
    np.testing.assert_allclose(eng.model.means, red.means)


def test_ntc_engine_native_9mer_matches_reference(model9_rna):
    """Batched engine at NATIVE K=4^9 (native_kmer=True, scan path) vs
    dynamont-NTC on a mid-size read: borders, states, and the true 9-mer
    polish column must match (ref: NTC_main.cpp:95-99 — the reference
    always runs 9-mer models at native K)."""
    import jax.numpy as jnp

    from dynamont_jax.models.batch import BatchItem
    from dynamont_jax.models.ntc_batch import NTCBatchEngine

    model, path = model9_rna
    sig, read = _make_read9(model, 120, seed=7, rna=True)
    p = _ref("dynamont-NTC", path, "rna004", sig, read)
    assert p.returncode == 0, p.stderr
    ref = []
    for part in p.stdout.splitlines()[0].strip().split(";"):
        if part:
            st, rest = part[0], part[1:].split(",")
            ref.append((st, int(rest[0]), int(rest[1]), float(rest[2]),
                        rest[3]))
    eng = NTCBatchEngine(model, "rna004", dtype=jnp.float64,
                         native_kmer=True, fallback=False,
                         t_pad_to=256, n_pad_to=16)
    assert eng.model.kmer_size == 9  # no reduction happened
    out = eng.run([BatchItem(sig, read)])[0]
    assert out.error is None, out.error
    assert len(out.segments) == len(ref)
    n_med = 0
    for g, r in zip(out.segments, ref):
        assert g[0] == r[0] and g[1] == r[1] and g[2] == r[2]
        assert g[4] == r[4], "polish column must be the native 9-mer"
        n_med += 0 if abs(g[3] - r[3]) < 1e-4 else 1
    assert n_med <= max(1, len(ref) // 10), n_med


def test_native_9mer_exact_path_refuses_long_reads(model9_rna):
    """The per-read fp64 fallback at K=4^9 would allocate ~4 T*K fp64
    matrices (~70 GB at production T, like the reference); the engine
    must refuse with a clear error instead of OOMing."""
    import jax.numpy as jnp
    import numpy as np

    from dynamont_jax.models.batch import BatchItem
    from dynamont_jax.models.ntc_batch import NTCBatchEngine

    model, _ = model9_rna
    eng = NTCBatchEngine(model, "rna004", dtype=jnp.float32,
                         native_kmer=True)
    sig = np.zeros(4096)  # (T+1)*K*8 ~ 8.6 GB > the 2 GiB guard
    out = eng._run_exact(BatchItem(sig, "A" * 500))
    assert out.error is not None and "too long" in out.error
    # guard boundary: reads under ~1k samples at K=4^9 stay eligible for
    # the exact path (the small-N parity tests depend on that)
    assert (1000 + 1) * model.num_kmers * 8 < 2**31
