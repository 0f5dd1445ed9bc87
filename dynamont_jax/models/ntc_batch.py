"""Batched NTC (resquiggle) engine: buckets reads into padded shapes and
runs the whole 5-state error-correcting pipeline as one device program per
bucket (replaces per-read `dynamont-NTC` child processes, ref:
NTC_main.cpp:8-235 + segment.py:292-317). The program is XLA scans
(ops/ntc_batch, ops/ntc_walk) on every platform.

Escalation mirrors the reference's implicit behavior: the reference's
hash-map lattice has no candidate cap, so reads whose 95%-mass columns
exceed this engine's static caps are re-run through the exact per-read
fp64 path (models/ntc.run_ntc, which escalates its own CAP_LADDER).
"""

from __future__ import annotations

import functools
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np

from dynamont_jax.constants import (
    EPSILON, NT_TRANSITIONS, NTK_TRANSITIONS, resolve_transitions,
)
from dynamont_jax.models.batch import BatchItem, BatchOutput
from dynamont_jax.models.nt import _validate
from dynamont_jax.ops import ntc_batch as nb
from dynamont_jax.ops import ntc_walk as nw
from dynamont_jax.utils.kmer import int2kmers_batch, seq_to_kmer_ids
from dynamont_jax.utils.pore_model import PoreModel

FP32_EPSILON = 1e-6  # per-cell Z tolerance for fp32 (see docs/DESIGN.md)

# big-K (native 9-mer) TK pre-pass: the 95%-mass crossing is searched in
# the top-48 values only (measured demand <= 16/column at T=16k; top-k
# cost scales with k — see ops.ntc_batch.pre_tk_batch_ckpt sel_cap).
# The wide overflow rung (CK0 > 128) keeps the full selection width.
BIGK_TK_SEL_CAP = 48


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_ntc_batch_fn(model: PoreModel, pore: str,
                      transition_overrides: dict | None = None,
                      dtype=jnp.float32):
    """Jitted bucket program: (sig, kmer_ids, T, N) -> per-read summaries.

    Transitions are static (baked into the program); model tables are jit
    arguments (XLA constant-folds gathers from closure constants)."""
    ntk = resolve_transitions(NTK_TRANSITIONS[pore], transition_overrides)
    trans_log = {k: math.log(v) for k, v in ntk.items()}
    nt = NT_TRANSITIONS[pore]
    log_ppm, log_ppe = math.log(nt["m1"]), math.log(nt["e2"])
    means, c1, c2 = model.score_params()
    tables_host = (jnp.asarray(means, dtype), jnp.asarray(model.stdevs, dtype),
                   jnp.asarray(c1, dtype), jnp.asarray(c2, dtype))
    table_cache: dict = {None: tuple(jax.device_put(t) for t in tables_host)}
    A = model.alphabet_size
    S = model.kmer_size
    K = model.num_kmers

    @functools.partial(jax.jit, static_argnames=("CN", "CK0", "S_max"))
    def run(sig, kmer_ids, T_r, N_r, mu, sd, c1a, c2a, CN, CK0, S_max):
        pn = nb.pre_tn_batch(
            sig, kmer_ids, N_r, T_r, mu, sd, log_ppm, log_ppe, CN, dtype
        )
        # big-K (native 9-mer): the dense (T, R*K) backward store and the
        # (T, K+1) plan scatter tables outgrow device memory at production
        # read lengths; switch to the checkpoint-recompute pre-pass and
        # the eq-broadcast plan when a read's TK store would top ~1 GB.
        # Both are bit-equal to the dense forms.
        R_b, Tm1 = sig.shape
        bigk = (Tm1 + 1) * K * jnp.dtype(dtype).itemsize > 2**30
        if bigk and (Tm1 + 1) % 128 == 0:
            sel = BIGK_TK_SEL_CAP if BIGK_TK_SEL_CAP < CK0 <= 128 else None
            pk = nb.pre_tk_batch_ckpt(
                sig, T_r, mu, c1a, c2a, log_ppm, log_ppe, A, CK0,
                dtype, sel_cap=sel,
            )
        else:
            bigk = False
            pk = nb.pre_tk_batch(
                sig, T_r, mu, c1a, c2a, log_ppm, log_ppe, A, CK0, dtype
            )
        plan, dims = nb.build_plan_batch(
            pn.cand, pn.cnt, pk.cand, pk.cnt, kmer_ids, N_r,
            mu, c1a, c2a, A, S, dtype, bigk=bigk, kn1=pn.kn1, kn2=pn.kn2,
        )
        sigd = sig.astype(dtype)
        bwd = nb.ntc_backward_batch(
            plan, dims, sigd, trans_log, N_r, T_r, S, dtype
        )
        Zb3 = nb.ntc_zb_batch(plan, dims, bwd[0])
        lp, choices, apE_final, fwdE_final = nb.ntc_posterior_viterbi_batch(
            plan, dims, sigd, bwd, Zb3, trans_log, N_r, T_r, S, dtype
        )
        Zf3 = nb.ntc_zf_batch(plan, dims, fwdE_final, N_r, T_r)
        i0, j0, k0, valid = nw.start_slots(plan, dims, apE_final, N_r, T_r)
        seg_cnt, st_a, bp_a, start_a, k_a, med, seg_ovf = nw.ntc_walk_batch(
            plan, dims, lp, choices, N_r, T_r, i0, j0, k0, valid, K, S, S_max,
        )
        return dict(
            Zf_tn=pn.Zf, Zb_tn=pn.Zb, ovf_tn=pn.overflow,
            Zf_tk=pk.Zf, Zb_tk=pk.Zb, ovf_tk=pk.overflow,
            Zf=Zf3, Zb=Zb3, valid_start=valid,
            seg_cnt=seg_cnt, seg_state=st_a, seg_bp=bp_a,
            seg_start=start_a, seg_k=k_a, seg_med=med, seg_ovf=seg_ovf,
        )

    def call(sig, kmer_ids, T_r, N_r, CN: int, CK0: int, S_max: int,
             device=None):
        if device not in table_cache:
            table_cache[device] = tuple(
                jax.device_put(t, device) for t in tables_host)
        means_t, sd_t, c1_t, c2_t = table_cache[device]
        if jnp.dtype(dtype) == jnp.float32:
            # fp32 programs trace with x64 off whatever the caller's
            # config (the train CLI and the fp64 parity paths turn it on):
            # one trace-time config for every fp32 bucket program
            with jax.enable_x64(False):
                return run(sig, kmer_ids, T_r, N_r, means_t, sd_t, c1_t,
                           c2_t, CN=CN, CK0=CK0, S_max=S_max)
        return run(sig, kmer_ids, T_r, N_r, means_t, sd_t, c1_t, c2_t,
                   CN=CN, CK0=CK0, S_max=S_max)

    return call


class NTCBatchEngine:
    """Production NTC segmentation over arbitrary read lists (bucketed,
    fp32 by default). Interface mirrors models.batch.BandedBatchEngine."""

    def __init__(
        self,
        model: PoreModel,
        pore: str,
        transition_overrides: dict | None = None,
        dtype=jnp.float32,
        batch_size: int = 16,
        max_batch_samples: int = 2_000_000,
        t_pad_to: int = 2048,
        n_pad_to: int = 256,
        cap_n: int = 8,
        cap_k: int = 112,  # TK 95%-mass columns need ~60-100 candidates
                           # at T=16k
        fallback: bool = True,
        wide_retry: bool = True,  # fp32 doubled-cap rung before exact fp64
        devices: list | None = None,  # round-robin targets (None = all local)
        native_kmer: bool = False,  # >5-mer models: run NTC at native K
    ):
        if model.kmer_size > 5 and native_kmer:
            # native big-K mode (ref: NTC_main.cpp:95-99 runs K=4^9
            # directly): the per-step scan path gains little from more
            # reads per bucket while the checkpoint state is ~3 GB/read,
            # so buckets stay small
            if batch_size == 16:  # default -> big-K-safe geometry
                batch_size = 2
            max_batch_samples = min(max_batch_samples, 36864)
        elif model.kmer_size > 5:
            # documented 9-mer fallback: NTC runs on the reduced 5-mer
            # tables (utils.pore_model.reduce_model_to_5mer; the dense TK
            # pre-pass is impractical at K=4^9 for production reads)
            from dynamont_jax.utils.pore_model import reduce_model_to_5mer

            print(
                f"NTC: reducing {model.kmer_size}-mer model to 5-mer "
                "(ref: models/9merTo5mer.py; --ntc-native-9mer for native "
                "K)", file=sys.stderr,
            )
            model = reduce_model_to_5mer(model)
        self.model = model
        self.pore = pore
        self.overrides = transition_overrides
        self.dtype = dtype
        self.batch_size = batch_size
        self.max_batch_samples = max_batch_samples
        self.t_pad_to = t_pad_to
        self.n_pad_to = n_pad_to
        self.cap_n = cap_n
        self.cap_k = cap_k
        self.fallback = fallback
        self.wide_retry = wide_retry
        # buckets round-robin across every local chip in one process (the
        # read axis is embarrassingly parallel, like the reference's
        # mp.Pool over reads, ref: segment.py:292-317)
        self.devices = list(devices) if devices else jax.local_devices()
        self._next_dev = 0
        # wall-clock accounting across run() calls (see --profile)
        self.profile = {"buckets": 0, "reads": 0, "dispatch_s": 0.0,
                        "collect_s": 0.0, "exact_retries": 0, "exact_s": 0.0,
                        "device_buckets": {}}
        self._fn = make_ntc_batch_fn(model, pore, transition_overrides, dtype)
        self._eps = EPSILON if jnp.dtype(dtype) == jnp.float64 else FP32_EPSILON

    # -- batching ----------------------------------------------------------
    def _buckets(self, idxs, items):
        """Row-optimal packing (models/packing.py)."""
        from dynamont_jax.models.packing import pack_buckets

        idxs = list(idxs)
        buckets = pack_buckets(
            [len(items[i].signal) for i in idxs],
            batch_size=self.batch_size,
            max_batch_samples=self.max_batch_samples,
            t_pad_to=self.t_pad_to,
        )
        for b in buckets:
            yield [idxs[p] for p in b]

    # -- execution ---------------------------------------------------------
    def dispatch(self, items: list[BatchItem]):
        """Phase 1: validate + asynchronously dispatch every bucket and
        pre-issue the D2H wave; returns a handle for collect(). The split
        lets the CLI keep several chunks in flight (see
        models/batch.BandedBatchEngine.dispatch)."""
        import time

        outputs: list[BatchOutput | None] = [None] * len(items)
        valid: list[int] = []
        for i, it in enumerate(items):
            try:
                _validate(len(it.signal), len(it.read), self.model.kmer_size)
            except SystemExit as e:
                outputs[i] = BatchOutput(
                    it, None, math.nan,
                    f"input validation failed (reference exit {e.code})",
                )
                continue
            valid.append(i)

        t0 = time.perf_counter()
        pending = [
            self._dispatch(gidx, items) for gidx in self._buckets(valid, items)
        ]
        # one async D2H wave over every bucket's result arrays: collect's
        # synchronous np.asarray calls would each wait for their own
        # transfer; async copies overlap each other and compute
        for bucket in pending:
            for arr in bucket[3].values():
                arr.copy_to_host_async()
        self.profile["dispatch_s"] += time.perf_counter() - t0
        return items, outputs, valid, pending

    def collect(self, handle) -> list[BatchOutput]:
        """Phase 2: wait for the handle's buckets, build outputs, and run
        the overflow escalation ladder on any reads that need it."""
        import time

        items, outputs, valid, pending = handle
        t1 = time.perf_counter()
        retry: list[int] = []
        for bucket in pending:
            retry += self._collect(bucket, items, outputs)
        t2 = time.perf_counter()
        # escalation ladder for cap-overflow reads: (1) one fp32 scan-path
        # bucket at doubled caps (shared across all overflowing reads —
        # far cheaper than the per-read fp64 path), (2) exact fp64
        use_wide = bool(retry) and self.fallback and self.wide_retry
        exact = self._run_wide(retry, items, outputs) if use_wide else retry
        t3 = time.perf_counter()
        for i in exact:
            outputs[i] = self._run_exact(items[i])
        self.profile["buckets"] += len(pending)
        self.profile["reads"] += len(valid)
        self.profile["collect_s"] += t2 - t1
        # wide_retries counts reads the RUNG actually processed; wide_s /
        # exact_s attribute the two rungs separately
        self.profile["wide_retries"] = (
            self.profile.get("wide_retries", 0)
            + (len(retry) if use_wide else 0))
        self.profile["exact_retries"] += len(exact)
        self.profile["wide_s"] = (
            self.profile.get("wide_s", 0.0) + (t3 - t2 if use_wide else 0.0))
        self.profile["exact_s"] += time.perf_counter() - t3
        return outputs  # type: ignore[return-value]

    def run(self, items: list[BatchItem]) -> list[BatchOutput]:
        return self.collect(self.dispatch(items))

    def _pad_bucket(self, gidx, items, r_pad: int | None = None):
        """Pack a bucket; r_pad forces the read-axis width (extra rows
        replicate read 0 and are never collected)."""
        R = len(gidx)
        T_arr = np.array([len(items[i].signal) + 1 for i in gidx], np.int32)
        kmer_ids = [
            np.asarray(
                seq_to_kmer_ids(items[i].read, self.model.kmer_size,
                                self.model.alphabet_size), np.int32,
            )
            for i in gidx
        ]
        N_arr = np.array([len(k) + 1 for k in kmer_ids], np.int32)
        R_pad = r_pad if r_pad is not None else R
        if R_pad != R:
            # fixed read-axis width: replicate the first read (extra
            # outputs are simply never collected)
            T_arr = np.concatenate([T_arr, np.repeat(T_arr[:1], R_pad - R)])
            N_arr = np.concatenate([N_arr, np.repeat(N_arr[:1], R_pad - R)])
        from dynamont_jax.models.packing import t_pad_ladder

        T_pad = t_pad_ladder(int(T_arr.max()), self.t_pad_to)
        N2 = round_up(int(N_arr.max()), self.n_pad_to)
        sig = np.zeros((R_pad, T_pad - 1), np.float32)
        kid = np.zeros((R_pad, N2 - 1), np.int32)
        for j in range(R_pad):
            i = gidx[j] if j < R else gidx[0]
            kj = kmer_ids[j] if j < R else kmer_ids[0]
            sig[j, : T_arr[j] - 1] = items[i].signal
            kid[j, : N_arr[j] - 1] = kj
        return T_arr, N_arr, sig, kid, N2

    def _next_device(self):
        dev = self.devices[self._next_dev % len(self.devices)]
        self._next_dev += 1
        db = self.profile["device_buckets"]
        db[str(dev.id)] = db.get(str(dev.id), 0) + 1
        return dev

    def _dispatch(self, gidx, items):
        T_arr, N_arr, sig, kid, N2 = self._pad_bucket(gidx, items)
        # segment cap: one per base plus polish slack (overflow -> fallback)
        S_max = round_up(N2 + N2 // 4 + 64, 128)
        dev = self._next_device()
        res = self._fn(
            jax.device_put(sig, dev), jax.device_put(kid, dev),
            jax.device_put(T_arr, dev), jax.device_put(N_arr, dev),
            CN=self.cap_n, CK0=self.cap_k, S_max=S_max, device=dev,
        )
        return gidx, T_arr, N_arr, res

    def _collect(self, bucket, items, outputs,
                 caps: tuple[int, int] | None = None) -> list[int]:
        """caps: effective (cap_n, cap_k) of the program that produced
        `res` — the wide retry rung runs at doubled caps, and the Z-gate
        cell count must reflect them; defaults to the engine caps."""
        gidx, T_arr, N_arr, res = bucket
        host = {k: np.asarray(v) for k, v in res.items()}
        K = self.model.num_kmers
        retry: list[int] = []
        for j, i in enumerate(gidx):
            it = items[i]
            T, N = int(T_arr[j]), int(N_arr[j])
            flags = [
                f for f in ("ovf_tn", "ovf_tk", "seg_ovf") if host[f][j]
            ]
            if not host["valid_start"][j]:
                flags.append("no_valid_start")
            if flags:
                if not self.fallback:
                    print(f"ntc fallback[{i}]: {','.join(flags)}",
                          file=sys.stderr)
                retry.append(i)
                continue
            err = self._z_errors(host, j, T, N, K, caps=caps)
            if err is not None:
                outputs[i] = BatchOutput(it, None, float(host["Zf"][j]), err)
                continue
            segs = self._format_segments(host, j)
            segs = self._renormalize_medians(host, j, segs)
            outputs[i] = BatchOutput(it, segs, float(host["Zf"][j]))
        return retry

    def _z_errors(self, host, j, T, N, K,
                  caps: tuple[int, int] | None = None):
        # "matrices" uses the SPARSE lattice size actually evaluated
        # (T x 5 states x CN x CK slots): T*N*K would make the per-cell
        # tolerance admit 1000+ nats of fwd/bwd divergence at T=16k
        cap_n, cap_k = caps if caps is not None else (self.cap_n, self.cap_k)
        cells3 = T * 5 * cap_n * (cap_k + cap_n)
        checks = (
            ("preProcTN", host["Zf_tn"][j], host["Zb_tn"][j], T * N, 1),
            ("preProcTK", host["Zf_tk"][j], host["Zb_tk"][j], T * K, 2),
            ("matrices", host["Zf"][j], host["Zb"][j], cells3, 3),
        )
        for name, zf, zb, cells, _code in checks:
            zf, zb = float(zf), float(zb)
            bad = (
                math.isinf(zf) or math.isinf(zb)
                or abs(zf - zb) / cells > self._eps
            )
            if bad:
                return (
                    f"Z values of {name} do not match! Zf: {zf}, Zb: {zb}"
                    if name != "matrices"
                    else f"Z values between matrices do not match! forZ: {zf}, backZ: {zb}"
                )
        return None

    def _format_segments(self, host, j):
        """Device summaries -> per-read segment tuples in read order,
        matching models/ntc.run_ntc: (state, basepos, start_t, prob,
        polish_kmer_str)."""
        cnt = int(host["seg_cnt"][j])
        if cnt <= 0:
            return []
        m = self.model
        rev = slice(cnt - 1, None, -1)
        states = host["seg_state"][j, rev].tolist()
        bps = host["seg_bp"][j, rev].tolist()
        starts = host["seg_start"][j, rev].tolist()
        meds = host["seg_med"][j, rev].tolist()
        polish = int2kmers_batch(host["seg_k"][j, rev], m.alphabet_size,
                                 m.kmer_size, m.rna)
        return [
            ("P" if st else "M", int(bp), int(t0), float(p), pk)
            for st, bp, t0, p, pk in zip(states, bps, starts, meds, polish)
        ]

    def _renormalize_medians(self, host, j, segs):
        """fp32 paths normalize posteriors by each column's OWN logsumexp
        (ops/ntc_batch.ntc_posterior_viterbi_batch) — equal to the reference's global Z
        (NTC_main.cpp:186) by the forward-backward identity and immune
        to the fp32 Z drift a global normalizer accumulates over 16k
        steps — so no host-side correction applies. The fp64 scan path
        keeps the reference's exact global normalizer, using Zb (saves a
        forward pass); rescale its medians to the reference's Zf: a
        uniform log-shift, exact because the grouped median is monotone
        in the probabilities."""
        if jnp.dtype(self.dtype) != jnp.float64:
            return segs
        diff = float(host["Zb"][j]) - float(host["Zf"][j])
        if diff == 0.0:
            return segs
        # reads with |Zb-Zf| this large fail _z_errors first; the guard
        # keeps a pathological read from raising OverflowError here
        scale = math.exp(min(diff, 700.0))
        return [(st, bp, t0, p * scale, pk) for st, bp, t0, p, pk in segs]

    # -- training ----------------------------------------------------------
    def train(self, items: list[BatchItem]) -> list:
        """Per-read Baum-Welch estimates through the exact per-read path
        (models/ntc.run_ntc, ref: NTC.cpp:923-1130). Returns, per read,
        either (trained_transitions, trained_emissions, Z) or an Exception
        (the contract of training.trainer's batch results)."""
        outputs: list = [None] * len(items)
        for i, it in enumerate(items):
            try:
                _validate(len(it.signal), len(it.read),
                          self.model.kmer_size)
            except SystemExit as e:
                outputs[i] = RuntimeError(
                    f"input validation failed (reference exit {e.code})")
                continue
            outputs[i] = self._train_exact(it)
        return outputs

    def _train_exact(self, it: BatchItem):
        from dynamont_jax.models.ntc import run_ntc

        try:
            res = run_ntc(it.signal, it.read, self.model, self.pore,
                          self.overrides, mode="train", validate=False)
            return (res.trained_transitions, res.trained_emissions, res.Z)
        except Exception as e:
            return e

    def _run_wide(self, idxs: list[int], items, outputs) -> list[int]:
        """fp32 wide-cap retry rung: overflowing reads re-run at doubled
        caps before any falls to the per-read fp64 CAP_LADDER cliff.
        Returns the reads that still overflow / fail their Z gates."""
        wide_n = max(16, 2 * self.cap_n)
        wide_k = max(256, 2 * self.cap_k)
        widths = (4, 8, 16)
        still: list[int] = []
        for gidx in self._wide_buckets(idxs, items, widths[-1]):
            R = len(gidx)
            # pad the read axis to a FIXED width: overflow counts vary
            # run to run, and every distinct R is a fresh compile — one
            # stable shape per T bucket instead
            r_pad = next((w for w in widths if R <= w), R)
            T_arr, N_arr, sig, kid, N2 = self._pad_bucket(
                gidx, items, r_pad=r_pad)
            S_max = round_up(N2 + N2 // 4 + 64, 128)
            dev = self._next_device()
            res = self._fn(
                jax.device_put(sig, dev), jax.device_put(kid, dev),
                jax.device_put(T_arr, dev), jax.device_put(N_arr, dev),
                CN=wide_n, CK0=wide_k, S_max=S_max, device=dev,
            )
            for arr in res.values():
                arr.copy_to_host_async()
            still += self._collect((gidx, T_arr, N_arr, res), items,
                                   outputs, caps=(wide_n, wide_k))
            # a wide-rung Z-gate failure is NOT terminal: these reads
            # previously went straight to the exact fp64 path and may
            # succeed there — escalate them instead of keeping the error
            for i in gidx:
                if (i not in still and outputs[i] is not None
                        and outputs[i].error is not None):
                    outputs[i] = None
                    still.append(i)
        if still:
            print(f"ntc wide-cap rung: {len(still)}/{len(idxs)} reads "
                  "still overflow; falling to exact fp64", file=sys.stderr)
        return still

    def _wide_buckets(self, idxs, items, width: int):
        """Bucket packing for the wide rung: at most `width` reads per
        bucket."""
        from dynamont_jax.models.packing import pack_buckets

        idxs = list(idxs)
        buckets = pack_buckets(
            [len(items[i].signal) for i in idxs],
            batch_size=min(self.batch_size, width),
            max_batch_samples=self.max_batch_samples,
            t_pad_to=self.t_pad_to,
        )
        for b in buckets:
            yield [idxs[p] for p in b]

    def _run_exact(self, it: BatchItem) -> BatchOutput:
        """Exact per-read fp64 fallback for cap-overflow reads."""
        if not self.fallback:
            return BatchOutput(
                it, None, math.nan, "candidate cap overflow (no fallback)"
            )
        # native big-K mode: the dense per-read path allocates ~4 T*K fp64
        # matrices (~70 GB at T=16k, K=4^9, like the reference) — refuse
        # instead of OOMing when the read is long; short reads (tests,
        # tiny amplicons) still take it
        K = self.model.num_kmers
        if (len(it.signal) + 1) * K * 8 > 2**31:
            return BatchOutput(
                it, None, math.nan,
                "candidate cap overflow (read too long for the exact "
                f"fp64 path at K={K}; retry with larger caps)",
            )
        from dynamont_jax.models.ntc import (
            NTCPreprocessError, NTCZError, run_ntc,
        )

        try:
            res = run_ntc(it.signal, it.read, self.model, self.pore,
                          self.overrides)
            return BatchOutput(it, res.segments, res.Z)
        except (NTCPreprocessError, NTCZError) as e:
            return BatchOutput(it, None, math.nan, str(e))
