"""Banded Triton kernels vs the scan implementation (interpret mode on CPU),
plus the band-width padding and the path choice they depend on."""

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

from tests.synthetic import make_read

M1, E2 = 0.019889650396799997, 0.9801103496029998
LM, LE = math.log(M1), math.log(E2)


@pytest.fixture(scope="module")
def setup():
    model = load_model_for_pore("rna002")
    items = [make_read(model, n_bases=40 + 10 * s, seed=s) for s in range(3)]
    kids = [
        seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size) for _, r in items
    ]
    batch = bb.prepare_batch(
        [s for s, _ in items], kids, model.means, model.stdevs,
        dtype=jnp.float32, t_pad_to=256,
    )
    return batch


def _allclose_band(a, b, T, atol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    for i in range(a.shape[0]):
        x, y = a[i, : int(T[i])], b[i, : int(T[i])]
        both_inf = np.isneginf(x) & np.isneginf(y)
        d = np.abs(np.where(both_inf, 0.0, x - y))
        assert np.nanmax(d) < atol, f"read {i}: max diff {np.nanmax(d)}"


def _scan_fwd(batch):
    return jax.vmap(bb._forward_single(batch, LM, LE))(
        batch.sig, batch.mu_pad, batch.c1_pad, batch.c2_pad, batch.bstart,
        batch.bw, batch.N,
    )


def _scan_bwd(batch):
    return jax.vmap(bb._backward_single(batch, LM, LE))(
        batch.sig, batch.mu_pad, batch.c1_pad, batch.c2_pad, batch.bstart,
        batch.bw, batch.N, batch.T,
    )


def test_forward_matches_scan(setup):
    batch = setup
    M, E, Zf = pk.forward(batch, LM, LE, interpret=True)
    Ms, Es = _scan_fwd(batch)
    T = np.asarray(batch.T)
    _allclose_band(M, Ms, T)
    _allclose_band(E, Es, T)
    r = np.arange(len(T))
    np.testing.assert_allclose(
        np.asarray(Zf), np.asarray(Es)[r, T - 1, np.asarray(batch.bw) + 1],
        rtol=1e-6)
    # rows past each read's end are -inf, never garbage
    for i, t in enumerate(T):
        assert np.isneginf(np.asarray(E)[i, t:]).all()


def test_backward_matches_scan(setup):
    batch = setup
    M, E, Zb = pk.backward(batch, LM, LE, interpret=True)
    Ms, Es = _scan_bwd(batch)
    T = np.asarray(batch.T)
    _allclose_band(M, Ms, T)
    _allclose_band(E, Es, T)
    r = np.arange(len(T))
    np.testing.assert_allclose(
        np.asarray(Zb), np.asarray(Es)[r, 0, np.asarray(batch.bw) + 1],
        rtol=1e-6)


def test_full_run_matches_scan(setup):
    """backward -> fused forward+posterior+Viterbi against the scan run:
    Z values, the Viterbi choice bits and the posteriors."""
    batch = setup
    bM, bE, Zb = pk.backward(batch, LM, LE, interpret=True)
    LPM, LPE, ch, Zf = pk.fwd_vit(batch, bM, bE, Zb, LM, LE, interpret=True)
    res_s = bb.banded_batch_run(batch, LM, LE)
    np.testing.assert_allclose(np.asarray(Zf), np.asarray(res_s.Zf),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(Zb), np.asarray(res_s.Zb),
                               rtol=1e-6)
    T = np.asarray(batch.T)
    ch_p, ch_s = np.asarray(ch) != 0, np.asarray(res_s.choices)
    for i in range(ch_p.shape[0]):
        assert (ch_p[i, : int(T[i])] == ch_s[i, : int(T[i])]).mean() > 0.999
    # the scan reports fp32 posteriors normalized per row (bb.row_lse)
    PM = np.exp(np.minimum(np.asarray(LPM - bb.row_lse(LPM, LPE)), 0.0))
    _allclose_band(
        np.log(np.nan_to_num(PM) + 1e-30),
        np.log(np.asarray(res_s.PM) + 1e-30), T, atol=1e-3,
    )


def test_fused_segment_entry_matches_scan_pipeline(setup):
    """The production chain (backward -> fused forward+posterior+Viterbi
    -> walk) yields the scan pipeline's Z values, segment starts and
    medians."""
    batch = setup
    N_max = int(np.asarray(batch.N).max())
    Zf_p, Zb_p, starts_p, med_p = pk.banded_segment(
        batch, N_max, LM, LE, interpret=True
    )
    res = bb.banded_batch_run(batch, LM, LE)
    walk = jax.vmap(dv._walk_single(batch.B, N_max))
    starts_s, med_s = walk(res.PM, res.PE, res.choices, batch.bstart,
                           batch.T, batch.N, batch.bw)
    np.testing.assert_allclose(np.asarray(Zf_p), np.asarray(res.Zf),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(Zb_p), np.asarray(res.Zb),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(starts_p),
                                  np.asarray(starts_s))
    np.testing.assert_allclose(np.asarray(med_p), np.asarray(med_s),
                               atol=1e-6)


def test_walk_matches_device_walk(setup):
    batch = setup
    res = bb.banded_batch_run(batch, LM, LE)
    N_max = int(np.asarray(batch.N).max())
    walk = jax.vmap(dv._walk_single(batch.B, N_max))
    starts_s, med_s = walk(res.PM, res.PE, res.choices, batch.bstart,
                           batch.T, batch.N, batch.bw)
    # the kernel walk consumes LOG posteriors (what fwd_vit stores)
    starts_p, med_p = pk.walk(
        jnp.log(res.PM), jnp.log(res.PE), res.choices, batch, N_max,
        interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(starts_p), np.asarray(starts_s))
    np.testing.assert_allclose(
        np.asarray(med_p), np.asarray(med_s), atol=1e-7
    )


@pytest.mark.parametrize("max_bw,B", [(1, 8), (20, 64), (61, 128),
                                      (62, 128), (63, 256), (200, 512),
                                      (300, 1024)])
def test_band_width_is_a_power_of_two(max_bw, B):
    """Triton blocks are powers of two: the band array pads 2*bw+3 cells
    up to the next one (403 -> 512 at the production band of 400)."""
    assert bb.band_width(max_bw) == B
    assert bb.band_width(max_bw) >= 2 * max_bw + 3


def test_wire_and_batch_share_band_width(setup):
    model = load_model_for_pore("rna002")
    sig, read = make_read(model, n_bases=90, seed=4)
    kid = seq_to_kmer_ids(read, model.kmer_size, model.alphabet_size)
    wire = dv.prepare_wire([sig], [kid])
    batch = bb.prepare_batch([sig], [kid], model.means, model.stdevs)
    assert wire.B == batch.B == bb.band_width(int(wire.bw[0]))


@pytest.mark.parametrize("backend,dtype,want", [
    ("gpu", jnp.float32, True),
    ("gpu", jnp.float64, False),
    ("cpu", jnp.float32, False),
    ("cpu", jnp.float64, False),
])
def test_kernel_path_choice(monkeypatch, backend, dtype, want):
    """One place picks the path, from the platform (and the kernels'
    float32 dtype) alone: no environment switch reaches it."""
    monkeypatch.setattr(pk.jax, "default_backend", lambda: backend)
    monkeypatch.setenv("DYNAMONT_USE_PALLAS", "1")
    assert pk.kernels_enabled(dtype) is want


def test_kernel_calls_name_their_backend(setup, monkeypatch):
    """Every pallas_call names the Triton route and runs compiled unless a
    caller passes interpret=True."""
    seen = []
    real = pk.pl.pallas_call

    def spy(*a, **kw):
        seen.append((kw.get("backend"), kw.get("interpret")))
        return real(*a, **kw)

    monkeypatch.setattr(pk.pl, "pallas_call", spy)
    batch = setup
    N_max = int(np.asarray(batch.N).max())
    pk.banded_segment(batch, N_max, LM, LE, interpret=True)
    assert seen == [("triton", True)] * 3
    import inspect

    for fn in (pk.backward, pk.forward, pk.fwd_vit, pk.walk,
               pk.banded_segment):
        assert inspect.signature(fn).parameters["interpret"].default is False


@pytest.mark.parametrize("which", ["backward", "forward", "segment", "train"])
def test_kernels_lower_for_cuda(setup, which):
    """Every kernel lowers through Pallas' Triton route for a CUDA target
    (lowering needs no card; the GPU's compiler itself runs only on the
    chip): catches operations the Triton lowering refuses."""
    from dynamont_jax.ops import nt_banded_train as bt

    batch = setup
    N_max = int(np.asarray(batch.N).max())
    kid = jnp.zeros((batch.sig.shape[0], N_max - 1), jnp.int32)
    mk = lambda *a: bb.BandedBatch(*a, batch.pad, batch.B)
    fn = {
        "backward": lambda *a: pk.backward(mk(*a), LM, LE),
        "forward": lambda *a: pk.forward(mk(*a), LM, LE),
        "segment": lambda *a: pk.banded_segment(mk(*a), N_max, LM, LE),
        "train": lambda *a: bt.banded_batch_train_kernels(
            mk(*a), LM, LE, kid, 1024),
    }[which]
    args = (batch.sig, batch.mu_pad, batch.c1_pad, batch.c2_pad,
            batch.bstart, batch.T, batch.N, batch.bw)
    with jax.enable_x64(False):
        text = jax.jit(fn).trace(*args).lower(
            lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text or "triton" in text
