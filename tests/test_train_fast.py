"""The kernels' banded training step (ops/nt_banded_train, Triton kernels
in interpret mode here) vs the exact scan oracle."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from dynamont_jax.models.registry import load_model_for_pore
from dynamont_jax.ops import nt_banded_batch as bb
from dynamont_jax.ops.nt_banded_train import (banded_batch_train_fast,
                                              kmer_moments)
from dynamont_jax.utils.kmer import seq_to_kmer_ids

from tests.synthetic import make_read

M1, E2 = 0.019889650396799997, 0.9801103496029998


@pytest.fixture(scope="module")
def model():
    return load_model_for_pore("rna002")


def _prep(model, n_reads=3):
    items = [make_read(model, n_bases=40 + 11 * s, seed=s)
             for s in range(n_reads)]
    sigs = [s for s, _ in items]
    kids = [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size)
            for _, r in items]
    batch = bb.prepare_batch(sigs, kids, model.means, model.stdevs,
                             dtype=jnp.float32)
    N_max = max(len(k) for k in kids) + 1
    kid_pad = np.zeros((n_reads, N_max - 1), dtype=np.int32)
    for i, k in enumerate(kids):
        kid_pad[i, : len(k)] = k
    return batch, jnp.asarray(kid_pad)


def test_fast_train_matches_scan(model):
    batch, kid_pad = _prep(model)
    args = (batch, math.log(M1), math.log(E2), kid_pad, model.num_kmers)
    ref = bb.banded_batch_train(*args)
    got = banded_batch_train_fast(*args, interpret=True)

    # fp32 reassociation bounds vs the scan oracle at these shapes (the
    # kernels sum the m1/e2 numerators as exp(term - Zf); the scan path
    # takes one logsumexp)
    np.testing.assert_allclose(np.asarray(got.Zf), np.asarray(ref.Zf),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.Zb), np.asarray(ref.Zb),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.m1), np.asarray(ref.m1),
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got.e2), np.asarray(ref.e2),
                               rtol=1e-4)
    ref_mask = np.asarray(ref.kmer_mask)
    got_mask = np.asarray(got.kmer_mask)
    np.testing.assert_array_equal(got_mask, ref_mask)
    np.testing.assert_allclose(np.asarray(got.means)[ref_mask],
                               np.asarray(ref.means)[ref_mask],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.stdevs)[ref_mask],
                               np.asarray(ref.stdevs)[ref_mask],
                               rtol=5e-4, atol=1e-4)


def test_fast_train_padded_reads_are_benign(model):
    """Degenerate padding rows (T=N=1) must not poison the fast path."""
    batch, kid_pad = _prep(model, n_reads=2)
    pad1 = lambda a: jnp.concatenate([a, jnp.zeros_like(a[:1])], axis=0)
    padded = bb.BandedBatch(
        sig=pad1(batch.sig), mu_pad=pad1(batch.mu_pad),
        c1_pad=pad1(batch.c1_pad), c2_pad=pad1(batch.c2_pad),
        bstart=pad1(batch.bstart),
        T=jnp.concatenate([batch.T, jnp.ones((1,), batch.T.dtype)]),
        N=jnp.concatenate([batch.N, jnp.ones((1,), batch.N.dtype)]),
        bw=jnp.concatenate([batch.bw, jnp.ones((1,), batch.bw.dtype)]),
        pad=batch.pad, B=batch.B,
    )
    kid3 = jnp.concatenate([kid_pad, jnp.zeros_like(kid_pad[:1])], axis=0)
    got = banded_batch_train_fast(padded, math.log(M1), math.log(E2),
                                  kid3, model.num_kmers, interpret=True)
    # the padding row yields no NaNs anywhere (pooled psum safety)
    for leaf in (got.m1, got.e2, got.means, got.stdevs):
        assert not np.isnan(np.asarray(leaf)).any()
    assert not np.asarray(got.kmer_mask)[2].any()


def test_kmer_moments_single_sample_kmer_counts():
    """A k-mer whose one position carries the weight of a single sample
    has variance 0 and still counts (fp64 keeps such an estimate with a
    stdev of ~1e-5); a k-mer whose positions carry no weight does not."""
    y = 1.5
    norm = jnp.array([[0.0, 1.0, 0.0]], jnp.float32)
    wy = jnp.array([[0.0, y, 0.0]], jnp.float32)
    wy2 = jnp.array([[0.0, y * y, 0.0]], jnp.float32)
    s0 = jnp.zeros((1,), jnp.float32)
    kids = jnp.array([[5, 7]], jnp.int32)
    means, stdevs, mask = kmer_moments(norm, wy, wy2, s0, kids,
                                       jnp.array([3]), 16)
    assert float(means[0, 5]) == y and float(stdevs[0, 5]) == 0.0
    assert bool(mask[0, 5])
    assert not bool(mask[0, 7]) and int(mask.sum()) == 1


def test_trainer_fp32_precision(model, tmp_path):
    """Trainer(precision='fp32') — the kernels on a GPU, the fp32 scans on
    the CPU — produces parameters close to the fp64 run on the same
    batch."""
    from dynamont_jax.io import readers
    from dynamont_jax.training.trainer import Trainer
    from dynamont_jax.utils.kmer import int2kmer
    from dynamont_jax.utils.pore_model import write_kmer_models

    items = []
    for s in range(4):
        sig, read_proc = make_read(model, n_bases=30, seed=80 + s)
        items.append((f"tr{s}", sig, read_proc[9:][::-1]))
    tsv = tmp_path / "train.tsv"
    with open(tsv, "w") as f:
        for rid, sig, read in items:
            f.write(f"{rid}\t{rid}\t"
                    f"{','.join(repr(float(x)) for x in sig)}\t{read}\n")
    model_tsv = tmp_path / "init.model"
    models = {}
    for k in range(model.num_kmers):
        kmer = int2kmer(k, model.alphabet_size, model.kmer_size, model.rna)
        models[kmer] = (float(model.means[k]), float(model.stdevs[k]))
    write_kmer_models(model_tsv, models)

    params = {}
    for prec in ("fp64", "fp32"):
        trainer = Trainer("basic", "rna002", str(tmp_path / prec),
                          str(model_tsv), batch_size=4, precision=prec)
        jobs = list(readers.generate_tsv_jobs(str(tsv), rna=True))
        dz = trainer.process_batch(jobs, epoch=0)
        trainer.close()
        assert dz is not None
        params[prec] = dict(trainer.transition_params)
    assert params["fp32"]["m1"] == pytest.approx(params["fp64"]["m1"],
                                                 rel=1e-3)
    assert params["fp32"]["e2"] == pytest.approx(params["fp64"]["e2"],
                                                 rel=1e-3)


@pytest.mark.parametrize("dist", [None, (0, 1)], ids=["local", "distributed"])
def test_trainer_batched_failure_raises(model, tmp_path, dist):
    """A failing batched step ends the run on the local and the
    multi-process path alike: nothing retrains the reads on a slower
    path."""
    from dynamont_jax.io import readers
    from dynamont_jax.training.trainer import Trainer
    from dynamont_jax.utils.kmer import int2kmer
    from dynamont_jax.utils.pore_model import write_kmer_models

    sig, read_proc = make_read(model, n_bases=30, seed=80)
    tsv = tmp_path / "train.tsv"
    tsv.write_text(f"r0\tr0\t{','.join(repr(float(x)) for x in sig)}\t"
                   f"{read_proc[9:][::-1]}\n")
    model_tsv = tmp_path / "init.model"
    write_kmer_models(model_tsv, {
        int2kmer(k, model.alphabet_size, model.kmer_size, model.rna):
            (float(model.means[k]), float(model.stdevs[k]))
        for k in range(model.num_kmers)})
    trainer = Trainer("basic", "rna002", str(tmp_path / "out"),
                      str(model_tsv), batch_size=1)
    trainer.dist = dist

    real, calls = trainer._train_batch_basic, []

    def fail_first(jobs):
        # only the training step fails; the post-update Z pass would run
        calls.append(len(jobs))
        if len(calls) == 1:
            raise RuntimeError("batched step failed")
        return real(jobs)

    trainer._train_batch_basic = fail_first
    jobs = list(readers.generate_tsv_jobs(str(tsv), rna=True))
    with pytest.raises(RuntimeError, match="batched step failed"):
        trainer.process_batch(jobs, epoch=0)
    trainer.close()
