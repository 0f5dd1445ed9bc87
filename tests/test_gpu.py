"""The banded Triton kernels compiled for the card (no interpret mode)
against the XLA scans, at small shapes.

These need an NVIDIA GPU and skip elsewhere; on a machine with one run
    DYNAMONT_TEST_GPU=1 python -m pytest -m gpu tests/test_gpu.py
(conftest.py keeps the suite on the CPU unless DYNAMONT_TEST_GPU=1)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamont_jax.models.registry import load_model_for_pore
from dynamont_jax.ops import nt_banded_batch as bb
from dynamont_jax.ops import nt_banded_device as dv
from dynamont_jax.ops import nt_banded_pallas as pk
from dynamont_jax.utils.kmer import seq_to_kmer_ids

from dynamont_jax.utils.synthetic import make_read

pytestmark = pytest.mark.gpu

M1, E2 = 0.019889650396799997, 0.9801103496029998
LM, LE = math.log(M1), math.log(E2)


@pytest.fixture(scope="module")
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with DYNAMONT_TEST_GPU=1 on "
                    "the card)")
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def setup(gpu):
    model = load_model_for_pore("rna002")
    items = [make_read(model, n_bases=60 + 15 * s, seed=s) for s in range(4)]
    kids = [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size)
            for _, r in items]
    batch = bb.prepare_batch([s for s, _ in items], kids, model.means,
                             model.stdevs, dtype=jnp.float32, t_pad_to=512)
    return model, batch, kids


def test_kernels_enabled_on_the_card(gpu):
    assert pk.kernels_enabled(jnp.float32)
    assert not pk.kernels_enabled(jnp.float64)


def test_compiled_segment_matches_scan_pipeline(setup):
    _, batch, _ = setup
    N_max = int(np.asarray(batch.N).max())
    Zf, Zb, starts, med = pk.banded_segment(batch, N_max, LM, LE)
    res = bb.banded_batch_run(batch, LM, LE)
    st_s, med_s = jax.vmap(dv._walk_single(batch.B, N_max))(
        res.PM, res.PE, res.choices, batch.bstart, batch.T, batch.N,
        batch.bw)
    np.testing.assert_allclose(np.asarray(Zf), np.asarray(res.Zf), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(Zb), np.asarray(res.Zb), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(starts), np.asarray(st_s))
    np.testing.assert_allclose(np.asarray(med), np.asarray(med_s), atol=1e-6)


def test_compiled_forward_backward_match_scan(setup):
    _, batch, _ = setup
    T = np.asarray(batch.T)
    r = np.arange(len(T))
    bw = np.asarray(batch.bw)
    _, E, Zf = pk.forward(batch, LM, LE)
    _, Eb, Zb = pk.backward(batch, LM, LE)
    _, Es = jax.vmap(bb._forward_single(batch, LM, LE))(
        batch.sig, batch.mu_pad, batch.c1_pad, batch.c2_pad, batch.bstart,
        batch.bw, batch.N)
    _, Ebs = jax.vmap(bb._backward_single(batch, LM, LE))(
        batch.sig, batch.mu_pad, batch.c1_pad, batch.c2_pad, batch.bstart,
        batch.bw, batch.N, batch.T)
    np.testing.assert_allclose(np.asarray(Zf),
                               np.asarray(Es)[r, T - 1, bw + 1], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(Zb),
                               np.asarray(Ebs)[r, 0, bw + 1], rtol=1e-6)
    for i, t in enumerate(T):
        a, b = np.asarray(E)[i, :t], np.asarray(Es)[i, :t]
        fin = np.isfinite(b)
        assert (np.isfinite(a) == fin).all()
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-6, atol=1e-4)


def test_compiled_train_step_matches_scan(setup):
    from dynamont_jax.ops.nt_banded_train import banded_batch_train_fast

    model, batch, kids = setup
    kid_pad = np.zeros((len(kids), max(len(k) for k in kids)), np.int32)
    for i, k in enumerate(kids):
        kid_pad[i, :len(k)] = k
    args = (batch, LM, LE, jnp.asarray(kid_pad), model.num_kmers)
    got = banded_batch_train_fast(*args)
    ref = bb.banded_batch_train(*args)
    # the bounds of tests/test_train_fast.py
    np.testing.assert_allclose(np.asarray(got.m1), np.asarray(ref.m1),
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got.e2), np.asarray(ref.e2),
                               rtol=1e-4)
    mask = np.asarray(ref.kmer_mask)
    np.testing.assert_array_equal(np.asarray(got.kmer_mask), mask)
    np.testing.assert_allclose(np.asarray(got.means)[mask],
                               np.asarray(ref.means)[mask],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.stdevs)[mask],
                               np.asarray(ref.stdevs)[mask],
                               rtol=5e-4, atol=1e-4)
