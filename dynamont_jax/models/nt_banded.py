"""End-to-end single-read banded NT pipeline — the production 'basic' mode
(ref: src/cpp/NT_banded_main.cpp; selected by dynamont-resquiggle --mode basic)."""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from dynamont_jax.constants import NT_TRANSITIONS, resolve_transitions
from dynamont_jax.models.nt import NTResult, ZConsistencyError, _emissions_to_dict, _validate
from dynamont_jax.ops import nt_banded
from dynamont_jax.ops.geometry import band_geometry, effective_bandwidth
from dynamont_jax.ops.nt_full import check_z
from dynamont_jax.utils.kmer import seq_to_kmer_ids
from dynamont_jax.utils.pore_model import PoreModel

DEFAULT_BAND = 400


def run_nt_banded(
    signal: np.ndarray,
    read: str,
    model: PoreModel,
    pore: str,
    transition_overrides: dict | None = None,
    mode: str = "segment",
    want_prob: bool = False,
    band: int = DEFAULT_BAND,
    dtype=jnp.float64,
    validate: bool = True,
) -> NTResult:
    import jax

    if jnp.dtype(dtype) == jnp.float64 and not jax.config.jax_enable_x64:
        # callers without jax_enable_x64 (e.g. the batch engine's fp32
        # Z-gate escalation) would otherwise get a SILENT downcast of
        # every f64 array to f32 — enable it for this trace so "exact
        # fp64" means what it says (mirrors models/ntc.run_ntc)
        with jax.enable_x64(True):
            return run_nt_banded(signal, read, model, pore,
                                 transition_overrides, mode, want_prob,
                                 band, dtype, validate)
    trans = resolve_transitions(NT_TRANSITIONS[pore], transition_overrides)
    if validate:
        _validate(len(signal), len(read), model.kmer_size)

    kmer_ids = seq_to_kmer_ids(read, model.kmer_size, model.alphabet_size)
    T = len(signal) + 1
    N = len(kmer_ids) + 1
    geom = band_geometry(T, N, effective_bandwidth(band, N))
    inputs = nt_banded.make_banded_inputs(signal, kmer_ids, model.means, model.stdevs, geom, dtype)

    mats = nt_banded.nt_banded_forward_backward(inputs, geom, trans["m1"], trans["e2"])
    if not check_z(mats.Zf, mats.Zb, T * geom.B):
        raise ZConsistencyError(
            f"Z values between matrices do not match! Zf: {float(mats.Zf)}, Zb: {float(mats.Zb)}"
        )

    result = NTResult(Z=float(mats.Zb))
    if mode == "calcZ":
        return result

    if mode == "train":
        result.trained_transitions = nt_banded.banded_train_transitions(mats, inputs, geom, trans)
        LPM, LPE = nt_banded.banded_posteriors(mats)
        means, stdevs = nt_banded.banded_train_emissions(
            signal, kmer_ids, LPM, LPE, geom, model.num_kmers
        )
        result.trained_emissions = _emissions_to_dict(means, stdevs, model)
        return result

    LPM, LPE = nt_banded.banded_posteriors(mats)
    choices = nt_banded.nt_banded_viterbi_choices(LPM, LPE, geom)
    result.segments = nt_banded.nt_banded_traceback(
        np.asarray(choices), np.asarray(LPM), np.asarray(LPE), geom, model.kmer_size
    )
    if want_prob:
        result.per_t_logprob = np.asarray(nt_banded.banded_per_t_logprob(LPM))
    return result
