"""End-to-end single-read NT (full-lattice) pipeline.

Ties together emission scoring, forward/backward, the Z invariant, posterior
matrices, Viterbi + traceback, and Baum-Welch updates — the JAX-native
equivalent of the dynamont-NT binary (ref: src/cpp/NT_main.cpp).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from dynamont_jax.constants import NT_TRANSITIONS, resolve_transitions
from dynamont_jax.ops import nt_full
from dynamont_jax.utils.kmer import int2kmer, seq_to_kmer_ids
from dynamont_jax.utils.pore_model import PoreModel


class ZConsistencyError(RuntimeError):
    """Forward and backward partition functions disagree (reference exit 3)."""

    exit_code = 3


@dataclass
class NTResult:
    segments: list | None = None
    Z: float = math.nan
    per_t_logprob: np.ndarray | None = None
    trained_transitions: dict | None = None
    trained_emissions: dict | None = None


def _validate(signal_len: int, read_len: int, kmer_size: int) -> None:
    """Input contract with reference exit codes (ref: utils.cpp:530-552)."""
    import sys

    def die(code, msg):
        print(msg, file=sys.stderr)
        raise SystemExit(code)

    if signal_len < 1:
        die(8, f"Signal: {signal_len} smaller than 1")
    if read_len < 1:
        die(9, f"Read: {read_len} smaller than 1")
    if signal_len + 1 < 2 * read_len:
        die(10, f"Signal: {signal_len + 1} smaller than read: {read_len}")
    if read_len < kmer_size:
        die(11, f"Read: {read_len} smaller than kmerSize of the pore type: {kmer_size}")


def run_nt(
    signal: np.ndarray,
    read: str,
    model: PoreModel,
    pore: str,
    transition_overrides: dict | None = None,
    mode: str = "segment",
    want_prob: bool = False,
    dtype=jnp.float64,
    validate: bool = True,
) -> NTResult:
    """Full-lattice NT run for one read.

    mode: 'segment' (MAP borders), 'calcZ', or 'train' (one Baum-Welch step).
    signal must already be normalized/filtered; read must be in processing
    orientation (RNA: 3'->5' with polyA prefix).
    """
    trans = resolve_transitions(NT_TRANSITIONS[pore], transition_overrides)
    if validate:
        _validate(len(signal), len(read), model.kmer_size)

    kmer_ids = seq_to_kmer_ids(read, model.kmer_size, model.alphabet_size)
    T = len(signal) + 1
    N = len(kmer_ids) + 1

    scores = nt_full.emission_scores(signal, kmer_ids, model.means, model.stdevs, dtype)
    mats = nt_full.nt_forward_backward(scores, trans["m1"], trans["e2"])
    if not nt_full.check_z(mats.Zf, mats.Zb, T * N):
        raise ZConsistencyError(
            f"Z values between matrices do not match! Zf: {float(mats.Zf)}, Zb: {float(mats.Zb)}"
        )

    result = NTResult(Z=float(mats.Zb))
    if mode == "calcZ":
        return result

    if mode == "train":
        tt = train_transitions(scores, mats, trans)
        means, stdevs = train_emissions(signal, kmer_ids, mats, model.num_kmers)
        result.trained_transitions = tt
        result.trained_emissions = _emissions_to_dict(means, stdevs, model)
        return result

    LPM, LPE = nt_full.posterior_matrices(mats)
    choices = nt_full.nt_viterbi_choices(LPM, LPE)
    result.segments = nt_full.nt_traceback(
        np.asarray(choices), np.asarray(LPM), np.asarray(LPE), model.kmer_size
    )
    if want_prob:
        result.per_t_logprob = np.asarray(nt_full.per_t_border_logprob(LPM))
    return result


def train_transitions(scores, mats: nt_full.NTMatrices, trans: dict) -> dict:
    """Baum-Welch transition update (ref: NT.cpp:193-229).

    newM1 = logsum_{t,n} forE[t,n] + log m1 + sc[t,n]   + backM[t+1,n+1]
    newE2 = logsum_{t,n} forE[t,n] + log e2 + sc[t,n-1] + backE[t+1,n]
    normalized so m1 + e2 = 1; e1 stays 1.
    """
    from dynamont_jax.utils.logmath import logsumexp

    log_m1 = math.log(trans["m1"])
    log_e2 = math.log(trans["e2"])
    # terms over t in [0, T-2]; scores rows align with sig[t]
    forE = mats.forE[:-1]  # (T-1, N)
    backM_next = mats.backM[1:]
    backE_next = mats.backE[1:]
    m1_terms = forE[:, :-1] + log_m1 + scores + backM_next[:, 1:]
    e2_terms = forE[:, 1:] + log_e2 + scores + backE_next[:, 1:]
    newM1 = logsumexp(m1_terms)
    newE2 = logsumexp(e2_terms)
    Ae = jnp.logaddexp(newE2, newM1)
    newM1 = jnp.where(jnp.isfinite(Ae), newM1 - Ae, newM1)
    newE2 = jnp.where(jnp.isfinite(Ae), newE2 - Ae, newE2)
    return {
        "m1": float(jnp.exp(newM1)),
        "e1": 1.0,
        "e2": float(jnp.exp(newE2)),
    }


def train_emissions(signal, kmer_ids, mats: nt_full.NTMatrices, num_kmers: int):
    """Baum-Welch emission update (ref: NT.cpp:245-332).

    gamma[t,n] = softmax over n of logaddexp(forM+backM, forE+backE); per-k-mer
    means are averages of per-position posterior-weighted signal means.
    """
    G = jnp.logaddexp(mats.forM + mats.backM, mats.forE + mats.backE)
    from dynamont_jax.utils.logmath import logsumexp

    s = logsumexp(G, axis=1, keepdims=True)
    G = jnp.where(jnp.isfinite(s), G - s, G)
    W = jnp.exp(G)  # (T, N)

    sig = jnp.asarray(signal, G.dtype)
    N = W.shape[1]
    # kmers[n] = sum_t W[t,n]*sig[t-1] / sum_t W[t,n]   (t from 1; W[0] has sig index -1)
    num = W[1:].T @ sig  # (N,)
    den = jnp.sum(W[1:], axis=0)
    pos_mean = jnp.where(den != 0, num / den, 0.0)

    kmer_ids = jnp.asarray(kmer_ids)
    counts = jnp.zeros(num_kmers, G.dtype).at[kmer_ids].add(1.0)
    safe_counts = jnp.where(counts > 0, counts, 1.0)
    means = jnp.zeros(num_kmers, G.dtype).at[kmer_ids].add(
        pos_mean[1:] / safe_counts[kmer_ids]
    )

    # second pass: variance around the *k-mer* mean
    diff = sig[None, :] - means[kmer_ids][:, None]  # (N-1, T-1)
    var_num = jnp.sum(W[1:].T[1:] * diff * diff, axis=1)  # (N-1,)
    pos_var = jnp.where(den[1:] > 0, var_num / den[1:], 0.0)
    stdevs = jnp.sqrt(
        jnp.zeros(num_kmers, G.dtype).at[kmer_ids].add(pos_var / safe_counts[kmer_ids])
    )
    return np.asarray(means), np.asarray(stdevs)


def _emissions_to_dict(means, stdevs, model: PoreModel) -> dict:
    """Only k-mers with nonzero trained stdev are reported (ref: NT.cpp:355-361)."""
    out = {}
    for k in range(model.num_kmers):
        if stdevs[k] != 0.0:
            kmer = int2kmer(k, model.alphabet_size, model.kmer_size, model.rna)
            out[kmer] = (float(means[k]), float(stdevs[k]))
    return out
