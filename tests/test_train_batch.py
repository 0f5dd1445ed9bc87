"""Batched + sharded Baum-Welch training: parity vs single-read path."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamont_jax.models.nt_banded import run_nt_banded
from dynamont_jax.models.registry import load_model_for_pore
from dynamont_jax.ops import nt_banded_batch as bb
from dynamont_jax.parallel import make_mesh, make_sharded_train_step, pool_params
from dynamont_jax.parallel.train_step import shard_batch_for_mesh
from dynamont_jax.utils.kmer import int2kmer, seq_to_kmer_ids

from tests.synthetic import make_read

M1, E2 = 0.019889650396799997, 0.9801103496029998


@pytest.fixture(scope="module")
def model():
    return load_model_for_pore("rna002")


def _prep(model, n_reads=3, dtype=jnp.float64):
    items = [make_read(model, n_bases=40 + 11 * s, seed=s) for s in range(n_reads)]
    sigs = [s for s, _ in items]
    reads = [r for _, r in items]
    kids = [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size) for r in reads]
    batch = bb.prepare_batch(sigs, kids, model.means, model.stdevs, dtype=dtype)
    N_max = max(len(k) for k in kids) + 1
    kid_pad = np.zeros((n_reads, N_max - 1), dtype=np.int32)
    for i, k in enumerate(kids):
        kid_pad[i, : len(k)] = k
    return items, batch, jnp.asarray(kid_pad)


def test_batched_train_matches_single(model):
    items, batch, kid_pad = _prep(model)
    res = bb.banded_batch_train(
        batch, math.log(M1), math.log(E2), kid_pad, model.num_kmers
    )
    for i, (sig, read) in enumerate(items):
        ref = run_nt_banded(sig, read, model, "rna002", mode="train")
        assert float(res.m1[i]) == pytest.approx(ref.trained_transitions["m1"], rel=1e-9)
        assert float(res.e2[i]) == pytest.approx(ref.trained_transitions["e2"], rel=1e-9)
        means = np.asarray(res.means[i])
        stdevs = np.asarray(res.stdevs[i])
        mask = np.asarray(res.kmer_mask[i])
        got = {
            int2kmer(k, model.alphabet_size, model.kmer_size, model.rna):
                (float(means[k]), float(stdevs[k]))
            for k in range(model.num_kmers)
            if mask[k]
        }
        want = ref.trained_emissions
        assert set(got) == set(want)
        for kmer in want:
            assert got[kmer][0] == pytest.approx(want[kmer][0], rel=1e-6, abs=1e-9)
            assert got[kmer][1] == pytest.approx(want[kmer][1], rel=1e-6, abs=1e-9)


def test_sharded_train_step_runs_on_mesh(model):
    mesh = make_mesh(8)
    items, batch, kid_pad = _prep(model, n_reads=5)
    sbatch, skid, R = shard_batch_for_mesh(batch, np.asarray(kid_pad), mesh)
    step = make_sharded_train_step(
        mesh, M1, E2, model.num_kmers, pad=sbatch.pad, B=sbatch.B,
        dtype=jnp.float64,
    )
    out = step(sbatch, skid)
    assert out.per_read.m1.shape[0] == sbatch.sig.shape[0]
    pooled = pool_params(out.pooled)
    assert pooled is not None
    assert pooled["Z"] < 0
    assert int(np.asarray(out.pooled.n_valid)) == R  # padding rows excluded
    # pooled m1 equals the mean of the real reads' estimates
    per_read_m1 = np.asarray(out.per_read.m1)[:R]
    assert pooled["m1"] == pytest.approx(float(per_read_m1.mean()), rel=1e-9)
    assert 0 < pooled["m1"] < 1
    assert 0 < pooled["e2"] < 1
