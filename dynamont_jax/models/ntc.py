"""End-to-end single-read NTC (resquiggle / error-correction) pipeline —
JAX-native equivalent of the dynamont-NTC binary (ref: src/cpp/NTC_main.cpp).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from dynamont_jax.constants import (
    EPSILON, NT_TRANSITIONS, NTK_TRANSITIONS, resolve_transitions,
)
from dynamont_jax.models.nt import _validate
from dynamont_jax.ops import nt_full, ntc_dp, ntc_pre
from dynamont_jax.utils.kmer import seq_to_kmer_ids
from dynamont_jax.utils.pore_model import PoreModel


class NTCPreprocessError(RuntimeError):
    """Z mismatch in a 2D pre-pass (reference exits 1/2)."""

    def __init__(self, which, msg):
        super().__init__(msg)
        self.exit_code = 1 if which == "TN" else 2


class NTCZError(RuntimeError):
    """Z mismatch in the 3D DP (reference exit 3)."""

    exit_code = 3


@dataclass
class NTCResult:
    Z: float = math.nan
    segments: list | None = None   # [(state, basepos, start_t, prob, polish_kmer)]
    trained_transitions: dict | None = None
    trained_emissions: dict | None = None


# candidate-cap escalation ladder: static shapes per rung, re-run on overflow
CAP_LADDER = [(8, 16), (16, 32), (32, 64), (64, 128)]


def run_ntc(
    signal: np.ndarray,
    read: str,
    model: PoreModel,
    pore: str,
    transition_overrides: dict | None = None,
    mode: str = "segment",
    dtype=jnp.float64,
    validate: bool = True,
) -> NTCResult:
    import jax

    if jnp.dtype(dtype) == jnp.float64 and not jax.config.jax_enable_x64:
        # callers without jax_enable_x64 (e.g. the resquiggle CLI's
        # overflow fallback) would otherwise get a SILENT downcast of
        # every f64 array to f32 — enable it for this trace so "exact
        # fp64" means what it says
        with jax.enable_x64(True):
            return run_ntc(signal, read, model, pore, transition_overrides,
                           mode, dtype, validate)
    if validate:
        _validate(len(signal), len(read), model.kmer_size)
    ntk = resolve_transitions(NTK_TRANSITIONS[pore], transition_overrides)
    trans_log = {k: math.log(v) for k, v in ntk.items()}
    nt = NT_TRANSITIONS[pore]
    log_ppm, log_ppe = math.log(nt["m1"]), math.log(nt["e2"])

    kmer_seq = np.asarray(
        seq_to_kmer_ids(read, model.kmer_size, model.alphabet_size), np.int32
    )
    T = len(signal) + 1
    N = len(kmer_seq) + 1
    K = model.num_kmers
    sig = jnp.asarray(signal, dtype)
    means, c1, c2 = model.score_params()

    # --- 2D pre-passes with cap escalation --------------------------------
    scores_tn = nt_full.emission_scores(signal, kmer_seq, model.means, model.stdevs, dtype)
    pn = pk = None
    for cap_n, cap_k in CAP_LADDER:
        pn = ntc_pre.pre_tn(scores_tn, log_ppm, log_ppe, cap_n)
        pk = ntc_pre.pre_tk(
            sig, jnp.asarray(means, dtype), jnp.asarray(c1, dtype),
            jnp.asarray(c2, dtype), log_ppm, log_ppe, model.alphabet_size, cap_k,
        )
        if not bool(pn.overflow) and not bool(pk.overflow):
            break
    _check_pre("TN", pn, T * N)
    _check_pre("TK", pk, T * K)

    # --- 3D sparse DP ------------------------------------------------------
    plan = ntc_dp.build_plan(
        pn.cand, pn.count, pk.cand, pk.count, jnp.asarray(kmer_seq),
        means, c1, c2, model.alphabet_size, model.kmer_size, dtype,
    )
    fwd = ntc_dp.ntc_forward(plan, sig, trans_log, N, model.alphabet_size, model.kmer_size)
    bwd = ntc_dp.ntc_backward(plan, sig, trans_log, N, model.alphabet_size, model.kmer_size)
    Zf, Zb = ntc_dp.ntc_z(plan, fwd, bwd, N)
    Zf, Zb = float(Zf), float(Zb)
    cells = float(T) * N * K
    if abs(Zf - Zb) / cells >= EPSILON or math.isinf(Zf) or math.isinf(Zb):
        raise NTCZError(
            f"Z values between matrices do not match! forZ: {Zf}, backZ: {Zb}"
        )

    result = NTCResult(Z=Zf)
    if mode == "calcZ":
        return result

    logp = fwd + bwd - Zf
    if mode == "train":
        from dynamont_jax.ops import ntc_train

        result.trained_transitions = ntc_train.train_transitions(
            plan, sig, fwd, bwd, logp, trans_log, Zf, N,
            model.alphabet_size, model.kmer_size,
        )
        result.trained_emissions = ntc_train.train_emissions(
            plan, sig, logp, model,
        )
        return result

    from dynamont_jax.ops import ntc_viterbi

    apsei = ntc_viterbi.ntc_max_dp(plan, logp, N)
    result.segments = ntc_viterbi.ntc_traceback(
        plan, np.asarray(apsei), np.asarray(logp), T, N, K,
        model,
    )
    return result


def _check_pre(which, p, cells):
    Zf, Zb = float(p.Zf), float(p.Zb)
    if abs(Zf - Zb) / cells > EPSILON or math.isinf(Zf) or math.isinf(Zb):
        raise NTCPreprocessError(
            which,
            f"Z values of preProc{which} matrices do not match! Zf: {Zf}, Zb: {Zb}",
        )
