"""Batched banded segmentation engine — groups reads into padded buckets and
runs the jitted banded DP once per bucket shape (replaces the reference's
one-process-per-read design, ref: segment.py:292-317).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from dynamont_jax.constants import NT_TRANSITIONS, resolve_transitions
from dynamont_jax.models.nt import _validate
from dynamont_jax.models.packing import pack_buckets, t_pad_ladder
from dynamont_jax.ops import nt_banded_batch as bb
from dynamont_jax.ops import nt_banded_device as dv
from dynamont_jax.utils.kmer import seq_to_kmer_ids
from dynamont_jax.utils.pore_model import PoreModel
from dynamont_jax import native


@dataclass
class BatchItem:
    """One read prepared for the DP (already normalized/filtered/oriented)."""

    signal: np.ndarray
    read: str
    meta: object = None  # carried through untouched (read id, signal id, ...)


@dataclass
class BatchOutput:
    item: BatchItem
    _segments: list | None  # None => failed read (or lazily built below)
    Z: float
    error: str | None = None
    # raw device summaries (starts_row, medians_row, N, kmer_size) — the
    # CLI formats CSV natively from these; segment tuples are only built
    # on demand (tests, plotting, library users)
    summaries: tuple | None = None

    @property
    def segments(self) -> list | None:
        if self._segments is None and self.summaries is not None:
            starts_row, medians_row, N, kmer_size = self.summaries
            self._segments = dv.summaries_to_segments(
                starts_row, medians_row, N, kmer_size
            )
        return self._segments


class BandedBatchEngine:
    """Runs banded segmentation over arbitrary read lists.

    Reads are bucketed by padded (T_pad, batch) shape so XLA compiles a small
    number of programs; each bucket executes as one device launch, and the
    host traceback for launch i overlaps the device compute of launch i+1
    (dispatch is async until the output arrays are materialized).
    """

    def __init__(
        self,
        model: PoreModel,
        pore: str,
        transition_overrides: dict | None = None,
        band: int = 400,
        dtype=jnp.float32,
        batch_size: int = 16,
        max_batch_samples: int = 2**22,
        t_pad_to: int = 512,
        device_pipeline: bool = True,
        hampel_on_device: bool = False,
        devices: list | None = None,
        fp64_fallback: bool = True,
    ):
        self.model = model
        self.pore = pore
        trans = resolve_transitions(NT_TRANSITIONS[pore], transition_overrides)
        self.m1, self.e2 = trans["m1"], trans["e2"]
        self.band = band
        self.dtype = dtype
        self.batch_size = batch_size
        self.max_batch_samples = max_batch_samples
        self.t_pad_to = t_pad_to
        self.device_pipeline = device_pipeline
        self.fp64_fallback = fp64_fallback
        # every local accelerator by default: buckets round-robin across
        # the chips of one host in a single process (the reference scales
        # over reads with mp.Pool, ref: segment.py:292-317; here the
        # embarrassingly-parallel axis is bucket -> chip)
        self.devices = list(devices) if devices else jax.local_devices()
        self._next_dev = 0
        # wall-clock accounting across run() calls: dispatch = host prep +
        # async submit, collect = device wait + D2H + summary decode;
        # device_buckets counts launches per device id
        self.profile = {"buckets": 0, "reads": 0, "dispatch_s": 0.0,
                        "collect_s": 0.0, "device_buckets": {}}
        if device_pipeline:
            means, c1, c2 = model.score_params()
            self._dev_run = dv.make_device_fn(
                self.m1, self.e2, means, c1, c2, dtype=dtype,
                hampel=hampel_on_device,
            )
        else:
            self._run = bb.make_banded_batch_fn(self.m1, self.e2)

    # -- batching ----------------------------------------------------------
    def _buckets(self, items: list[BatchItem]):
        """Pack reads into padded buckets minimizing device rows (see
        models/packing.py): equal-pad reads group together instead of a
        short read paying a long read's padding."""
        yield from pack_buckets(
            [len(it.signal) for it in items],
            batch_size=self.batch_size,
            max_batch_samples=self.max_batch_samples,
            t_pad_to=self.t_pad_to,
        )

    # -- execution ---------------------------------------------------------
    def dispatch(self, items: list[BatchItem]):
        """Phase 1: validate + asynchronously dispatch every bucket (JAX
        async dispatch overlaps H2D/compute/D2H across buckets) and
        pre-issue the D2H wave. Returns a handle for collect(). Splitting
        the phases lets the CLI keep several chunks in flight (dispatch
        chunk i+1 while collecting chunk i) so the device never idles
        between chunks (ref: the reference pipeline never idles between
        reads, segment.py:292-317)."""
        import time

        outputs: list[BatchOutput | None] = [None] * len(items)
        valid: list[int] = []
        for i, it in enumerate(items):
            err = self._validate(it)
            if err is not None:
                outputs[i] = BatchOutput(it, None, math.nan, err)
            else:
                valid.append(i)
        pending = []
        t0 = time.perf_counter()
        if self.device_pipeline:
            for group in self._buckets([items[i] for i in valid]):
                gidx = [valid[g] for g in group]
                pending.append(
                    self._dispatch_bucket([items[i] for i in gidx], gidx))
            # pre-issue EVERY bucket's D2H as one async wave: a synchronous
            # np.asarray in collect would wait for its own transfer, while
            # async copies overlap each other and the remaining compute
            for bucket in pending:
                res = bucket[3]
                for arr in (res.Zf, res.Zb, res.starts, res.medians):
                    arr.copy_to_host_async()
        self.profile["dispatch_s"] += time.perf_counter() - t0
        return items, outputs, valid, pending

    def collect(self, handle) -> list[BatchOutput]:
        """Phase 2: wait for the handle's buckets and build outputs."""
        import time

        items, outputs, valid, pending = handle
        t1 = time.perf_counter()
        if self.device_pipeline:
            for bucket in pending:
                self._collect_bucket(bucket, outputs)
            self.profile["buckets"] += len(pending)
            self.profile["collect_s"] += time.perf_counter() - t1
            self.profile["reads"] += len(valid)
        else:
            for group in self._buckets([items[i] for i in valid]):
                gidx = [valid[g] for g in group]
                self._run_bucket([items[i] for i in gidx], gidx, outputs)
        return outputs  # type: ignore[return-value]

    def run(self, items: list[BatchItem]) -> list[BatchOutput]:
        return self.collect(self.dispatch(items))

    def _dispatch_bucket(self, its: list[BatchItem], gidx):
        kmer_ids = [
            seq_to_kmer_ids(it.read, self.model.kmer_size, self.model.alphabet_size)
            for it in its
        ]
        dev = self.devices[self._next_dev % len(self.devices)]
        self._next_dev += 1
        t_pad = t_pad_ladder(
            max(len(it.signal) for it in its) + 1, self.t_pad_to)
        wire = dv.prepare_wire(
            [it.signal for it in its], kmer_ids, band=self.band,
            t_pad_to=self.t_pad_to, device=dev, t_pad=t_pad,
            n_pad_to=128,
        )
        if jnp.dtype(self.dtype) == jnp.float32:
            # fp32 programs trace with x64 off regardless of the caller's
            # config (see models/ntc_batch.make_ntc_batch_fn)
            with jax.enable_x64(False):
                res = self._dev_run(wire, device=dev)
        else:
            res = self._dev_run(wire, device=dev)
        db = self.profile["device_buckets"]
        db[str(dev.id)] = db.get(str(dev.id), 0) + 1
        return its, gidx, wire, res

    def _collect_bucket(self, bucket, outputs):
        its, gidx, wire, res = bucket
        Zf = np.asarray(res.Zf, dtype=np.float64)
        Zb = np.asarray(res.Zb, dtype=np.float64)
        starts = np.asarray(res.starts)
        medians = np.asarray(res.medians)
        T = np.asarray(wire.T)
        N = np.asarray(wire.N)
        ok = bb.check_z_batch(Zf, Zb, T, wire.B, self.dtype)
        for j, out_i in enumerate(gidx):
            if not ok[j]:
                outputs[out_i] = self._z_fail(its[j], float(Zf[j]),
                                              float(Zb[j]))
            else:
                outputs[out_i] = BatchOutput(
                    its[j], None, float(Zb[j]),
                    summaries=(starts[j], medians[j], int(N[j]),
                               self.model.kmer_size),
                )

    def _validate(self, it: BatchItem) -> str | None:
        try:
            _validate(len(it.signal), len(it.read), self.model.kmer_size)
        except SystemExit as e:
            return f"input validation failed (reference exit {e.code})"
        return None

    def _run_bucket(self, its: list[BatchItem], gidx, outputs):
        kmer_ids = [
            seq_to_kmer_ids(it.read, self.model.kmer_size, self.model.alphabet_size)
            for it in its
        ]
        batch = bb.prepare_batch(
            [it.signal for it in its], kmer_ids,
            self.model.means, self.model.stdevs,
            band=self.band, dtype=self.dtype, t_pad_to=self.t_pad_to,
        )
        res = self._run(batch)
        Zf = np.asarray(res.Zf, dtype=np.float64)
        Zb = np.asarray(res.Zb, dtype=np.float64)
        T = np.asarray(batch.T)
        N = np.asarray(batch.N)
        bw = np.asarray(batch.bw)
        ok = bb.check_z_batch(Zf, Zb, T, batch.B, self.dtype)
        seg_lists = native.banded_traceback_batch(
            np.asarray(res.choices), np.asarray(res.PM), np.asarray(res.PE),
            np.asarray(batch.bstart), T, N, bw, self.model.kmer_size,
        )
        for j, out_i in enumerate(gidx):
            if not ok[j]:
                outputs[out_i] = self._z_fail(its[j], float(Zf[j]),
                                              float(Zb[j]))
            else:
                outputs[out_i] = BatchOutput(its[j], seg_lists[j], float(Zb[j]))

    def _z_fail(self, it: BatchItem, zf: float, zb: float) -> BatchOutput:
        """Z-gate failure handling. fp64 gate failures are terminal — the
        reference's exit-3 contract (NT_banded_main.cpp:156-183). A read
        that only fails the batched fp32 gate (FP32_EPSILON) is usually
        fp32 round-off, not a real inconsistency: escalate it to the
        exact per-read fp64 path (mirrors the NTC overflow/Z ladder)
        instead of losing it to the error sidecar."""
        err = (f"Z values between matrices do not match! "
               f"Zf: {zf}, Zb: {zb}")
        if jnp.dtype(self.dtype) == jnp.float32 and self.fp64_fallback:
            self.profile["z_retries"] = self.profile.get("z_retries", 0) + 1
            from dynamont_jax.models.nt import ZConsistencyError
            from dynamont_jax.models.nt_banded import run_nt_banded

            try:
                res = run_nt_banded(
                    it.signal, it.read, self.model, self.pore,
                    {"m1": self.m1, "e2": self.e2}, band=self.band,
                    dtype=jnp.float64, validate=False,
                )
                return BatchOutput(it, res.segments, res.Z)
            except ZConsistencyError as e:
                return BatchOutput(it, None, zb, str(e))
        return BatchOutput(it, None, zb, err)
