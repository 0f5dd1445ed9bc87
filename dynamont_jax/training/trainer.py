"""Mini-batch Baum-Welch training driver (ref: src/python/segmentation/
train.py).

Faithful port of the reference training loop semantics — sliding-window
(ManagedList) pooling of per-read estimates, per-batch model checkpoints,
params.csv logging with post-update Z re-evaluation — with the per-read C++
child processes replaced by the batched banded training op (basic mode) or
the NTC trainer (resquiggle mode).
"""

from __future__ import annotations

import math
import os
import sys
from collections import deque
from datetime import datetime
from os.path import join

import numpy as np

from dynamont_jax.constants import (
    NTK_PARAM_NAMES, TRAIN_INIT_NT, TRAIN_INIT_NTK, is_rna,
)
from dynamont_jax.utils.pore_model import (
    pore_model_from_dict, read_kmer_models, write_kmer_models,
)


class ManagedList:
    """Sliding-window estimator (ref: train.py:19-46)."""

    def __init__(self, values, max_size: int = 100):
        self.values = deque(values, maxlen=max_size)

    def add(self, value):
        self.values.append(value)

    def get_list(self):
        return list(self.values)

    def mean(self):
        if not self.values:
            return None
        return float(np.mean(self.values))

    def median(self):
        if not self.values:
            return None
        return float(np.median(self.values))

    def __repr__(self):
        return f"ManagedList({list(self.values)})"


def nucleotide_ratios(seq: str) -> dict:
    """Fraction of each base (ref: FileIO.py countNucleotides + ratio)."""
    L = max(1, len(seq))
    return {b: seq.count(b) / L for b in "ACGT"}


def find_resume_state(outdir: str, param_names) -> dict | None:
    """Last trainable position recorded under outdir, or None.

    Parses params.csv (tolerating a final partial line from an interrupted
    run — the checkpoint model and the transition values are flushed before
    the post-update Z re-evaluation appends Zchange) and returns the last
    epoch/batch, the reads count, the transition values, and how many
    batches of the last epoch are already done."""
    csv_path = join(outdir, "params.csv")
    if not os.path.exists(csv_path):
        return None
    n_params = len(param_names)
    last = None
    per_epoch: dict = {}
    with open(csv_path) as f:
        next(f, None)  # header
        for line in f:
            fields = line.rstrip("\n").split(",")
            if len(fields) < 3 + n_params:
                continue
            try:
                e, b, r = int(fields[0]), int(fields[1]), int(fields[2])
                vals = [float(v) for v in fields[3:3 + n_params]]
            except ValueError:
                continue
            per_epoch[e] = per_epoch.get(e, 0) + 1
            last = (e, b, r, vals)
    if last is None:
        return None
    e, b, r, vals = last
    ckpt = join(outdir, f"trained_{e}_{b}.model")
    if not os.path.exists(ckpt):
        return None
    return {
        "epoch": e, "batch": b, "reads": r, "ckpt": ckpt,
        "transitions": dict(zip(param_names, vals)),
        "batches_done_in_epoch": per_epoch[e],
    }


class Trainer:
    """One training run over batches of reads."""

    def __init__(self, mode: str, pore: str, outdir: str,
                 model_path: str, batch_size: int = 24, epochs: int = 1,
                 resume: bool = False, precision: str = "fp64",
                 distributed: bool = False):
        assert mode in ("basic", "resquiggle")
        assert precision in ("auto", "fp64", "fp32")
        self.mode = mode
        # multi-host data parallelism: every process
        # sees the same job stream, trains the round-robin shard
        # jobs[process_index::process_count] of each batch, and the
        # per-read estimates are merged across processes with a summed
        # process_allgather before the (deterministic, identical on every
        # process) ManagedList pooling. Only process 0 writes params.csv
        # and model checkpoints. jax.distributed must be initialized
        # before constructing the Trainer (cli/train.py --distributed).
        self.dist = None
        if distributed:
            import jax

            self.dist = (jax.process_index(), jax.process_count())
            print(f"distributed training: process {self.dist[0]} of "
                  f"{self.dist[1]}", file=sys.stderr)
        # fp64 = reference-parity scan path (EPSILON Z-invariant); fp32 =
        # the dtype-scaled Z tolerance, on the GPU kernels where
        # ops/nt_banded_pallas.kernels_enabled says so. "auto" takes fp32
        # exactly there: on an H100 the kernel step trains a 24-read
        # 16k-sample batch about 10x faster than the fp64 scans, and
        # chip_smoke.py bounds the fp32 parameters against fp64 on full
        # and on trimmed signals (PERF.md)
        if precision == "auto":
            import jax.numpy as jnp

            from dynamont_jax.ops.nt_banded_pallas import kernels_enabled

            precision = "fp32" if kernels_enabled(jnp.float32) else "fp64"
            print(f"precision auto -> {precision}", file=sys.stderr)
        self.precision = precision
        self.pore = pore
        self.rna = is_rna(pore)
        self.outdir = outdir
        self.batch_size = batch_size
        self.epochs = epochs
        os.makedirs(outdir, exist_ok=True)

        init = TRAIN_INIT_NT if mode == "basic" else TRAIN_INIT_NTK
        state = find_resume_state(outdir, list(init)) if resume else None
        self.resume_epoch = 0
        self.resume_skip_batches = 0
        if state is not None:
            # continue from the last checkpoint; like a reference restart
            # via --model_path, the ManagedList windows restart from the
            # pooled values (their history is not persisted)
            model_path = state["ckpt"]
            self.resume_epoch = state["epoch"]
            self.resume_skip_batches = state["batches_done_in_epoch"]
            print(
                f"resume: epoch {state['epoch']}, batch {state['batch']} "
                f"({state['reads']} reads done) from {state['ckpt']}",
                file=sys.stderr,
            )

        self.kmer_models = read_kmer_models(model_path)
        self.transition_params = (
            dict(state["transitions"]) if state is not None else dict(init)
        )

        # ManagedList pools (ref: train.py:110-111)
        self.param_collector = {
            kmer: (ManagedList([m]), ManagedList([s]))
            for kmer, (m, s) in self.kmer_models.items()
        }
        self.param_collector.update(
            {p: ManagedList([v]) for p, v in self.transition_params.items()}
        )

        if state is None:
            self.ckpt_path = join(outdir, "trained_0_0.model")
            if self._is_writer:
                write_kmer_models(self.ckpt_path, self.kmer_models)
                self.params_csv = open(join(outdir, "params.csv"), "w")
                self.params_csv.write(
                    "epoch,batch,read,"
                    + ",".join(self.transition_params) + ",Zchange\n"
                )
            else:
                self.params_csv = open(os.devnull, "w")
            self.reads_done = 0
            self.batch_num = 0
        else:
            self.ckpt_path = state["ckpt"]
            csv_path = join(outdir, "params.csv")
            if self._is_writer:
                # terminate a partial final row (interrupt between the
                # params flush and the Zchange append) so new rows don't
                # merge onto it
                with open(csv_path, "rb") as f:
                    f.seek(0, 2)
                    size = f.tell()
                    newline_missing = False
                    if size:
                        f.seek(size - 1)
                        newline_missing = f.read(1) != b"\n"
                self.params_csv = open(csv_path, "a")
                if newline_missing:
                    self.params_csv.write("\n")
            else:
                self.params_csv = open(os.devnull, "w")
            self.reads_done = state["reads"]
            self.batch_num = state["batch"]

    @property
    def _is_writer(self) -> bool:
        return self.dist is None or self.dist[0] == 0

    # -- per-read training ------------------------------------------------
    def _train_batch_basic(self, jobs: list) -> list:
        """All reads of a batch through the batched banded Baum-Welch op in
        one device launch (per-read estimates proven identical to the
        single-read path; see tests/test_train_batch.py). Returns a list of
        (trained_transitions, trained_emissions, Z) or Exception per job."""
        import jax.numpy as jnp
        import numpy as np

        from dynamont_jax.ops import nt_banded_batch as bb
        from dynamont_jax.utils.kmer import int2kmer, seq_to_kmer_ids

        model = pore_model_from_dict(self.kmer_models, self.rna)
        kids = [
            seq_to_kmer_ids(j.read, model.kmer_size, model.alphabet_size)
            for j in jobs
        ]
        dtype = jnp.float64 if self.precision == "fp64" else jnp.float32
        # shapes are bucketed coarsely (T to 2048, N to 256) so successive
        # batches of varying read lengths reuse the compiled step; the
        # transitions enter as traced scalars
        batch = bb.prepare_batch(
            [j.signal for j in jobs], kids, model.means, model.stdevs,
            dtype=dtype, t_pad_to=2048, n_pad_to=256,
        )
        N_max = int(np.asarray(batch.N).max())
        N_max = (N_max - 1 + 255) // 256 * 256 + 1
        kid_pad = np.zeros((len(jobs), N_max - 1), dtype=np.int32)
        for i, k in enumerate(kids):
            kid_pad[i, : len(k)] = k
        res = self._run_step(batch, kid_pad, model, dtype)
        eps = bb.z_epsilon(dtype)
        Zf = np.asarray(res.Zf, np.float64)
        Zb = np.asarray(res.Zb, np.float64)
        T = np.asarray(batch.T, np.float64)
        out = []
        for i in range(len(jobs)):
            if not (
                np.isfinite(Zf[i]) and np.isfinite(Zb[i])
                and abs(Zf[i] - Zb[i]) / (T[i] * batch.B) <= eps
            ):
                out.append(RuntimeError(
                    f"Z values between matrices do not match! Zf: {Zf[i]}, Zb: {Zb[i]}"
                ))
                continue
            trans = {
                "m1": float(res.m1[i]), "e1": 1.0, "e2": float(res.e2[i]),
            }
            means = np.asarray(res.means[i])
            stdevs = np.asarray(res.stdevs[i])
            mask = np.asarray(res.kmer_mask[i])
            emis = {
                int2kmer(k, model.alphabet_size, model.kmer_size, model.rna):
                    (float(means[k]), float(stdevs[k]))
                for k in range(model.num_kmers)
                if mask[k]
            }
            out.append((trans, emis, float(Zb[i])))
        return out

    def _run_step(self, batch, kid_pad, model, dtype):
        """One Baum-Welch step over the batch: single-device jitted step,
        or the shard_map data-parallel step over every visible device.
        Both take the GPU kernels or the scans by
        ops/nt_banded_pallas.kernels_enabled; transition updates between
        batches enter as traced scalars, so neither recompiles per
        batch."""
        import contextlib
        import math

        import jax
        import jax.numpy as jnp

        from dynamont_jax.ops import nt_banded_batch as bb
        from dynamont_jax.ops.nt_banded_pallas import kernels_enabled
        from dynamont_jax.ops.nt_banded_train import banded_batch_train_fast

        m1 = self.transition_params["m1"]
        e2 = self.transition_params["e2"]
        fp32 = jnp.dtype(dtype) == jnp.float32
        # fp32 programs trace with x64 off (cli/train.py turns it on for
        # the fp64 path); all their inputs are explicitly fp32/int32
        x64 = jax.enable_x64(False) if fp32 else contextlib.nullcontext()
        if jax.device_count() == 1:
            step = (banded_batch_train_fast if kernels_enabled(dtype)
                    else bb.banded_batch_train_jit)
            with x64:
                return step(batch, math.log(m1), math.log(e2),
                            jnp.asarray(kid_pad), model.num_kmers)

        from dynamont_jax.parallel import make_mesh, make_sharded_train_step
        from dynamont_jax.parallel.train_step import shard_batch_for_mesh

        if not hasattr(self, "_mesh"):
            self._mesh = make_mesh(len(jax.devices()))
            self._sharded_steps = {}
        sbatch, skid, _ = shard_batch_for_mesh(batch, kid_pad, self._mesh)
        key = (sbatch.pad, sbatch.B, jnp.dtype(dtype).name)
        step = self._sharded_steps.get(key)
        if step is None:
            step = make_sharded_train_step(
                self._mesh, m1, e2, model.num_kmers,
                pad=sbatch.pad, B=sbatch.B, dtype=dtype)
            self._sharded_steps[key] = step
        with x64:
            return step(sbatch, skid, m1_cur=m1, e2_cur=e2).per_read

    def _train_batch_ntc(self, jobs: list) -> list:
        """All reads of a batch through the NTC engine's trainer (the
        exact per-read path, models/ntc_batch.NTCBatchEngine.train)."""
        from dynamont_jax.models.batch import BatchItem
        from dynamont_jax.models.ntc_batch import NTCBatchEngine

        model = pore_model_from_dict(self.kmer_models, self.rna)
        eng = NTCBatchEngine(
            model, self.pore, self.transition_params,
            batch_size=max(1, len(jobs)),
        )
        return eng.train([BatchItem(j.signal, j.read) for j in jobs])

    # -- multi-host exchange ----------------------------------------------
    def _kmer_codec(self):
        """(param_names, kmer->index map, index->kmer list) for the dense
        cross-process estimate encoding."""
        from dynamont_jax.utils.kmer import int2kmer

        any_kmer = next(iter(self.kmer_models))
        S = len(any_kmer)
        A, K = 4, 4 ** S
        rna = self.rna
        idx2kmer = [int2kmer(k, A, S, rna) for k in range(K)]
        kmer2idx = {km: k for k, km in enumerate(idx2kmer)}
        return list(self.transition_params), kmer2idx, idx2kmer, K

    def _train_batch_distributed(self, jobs: list) -> list:
        """Train the local round-robin shard, then merge every process's
        per-read estimates into full batch order (summed allgather of
        dense per-slot arrays — each slot is filled by exactly one
        process). All processes return identical results, so the
        ManagedList pooling that follows stays deterministic and
        bit-identical across hosts."""
        import numpy as np
        from jax.experimental import multihost_utils

        pid, nproc = self.dist
        local = jobs[pid::nproc]
        if self.mode == "basic":
            local_results = self._train_batch_basic(local)
        else:
            local_results = self._train_batch_ntc(local)

        names, kmer2idx, idx2kmer, K = self._kmer_codec()
        B = len(jobs)
        ok = np.zeros(B)
        trans = np.zeros((B, len(names)))
        z = np.zeros(B)
        means = np.zeros((B, K))
        stdevs = np.zeros((B, K))
        mask = np.zeros((B, K))
        for i, r in enumerate(local_results):
            j = pid + nproc * i
            if isinstance(r, Exception):
                print(f"read {jobs[j].readid} failed on process {pid}: {r}",
                      file=sys.stderr)
                continue
            tr, emis, zv = r
            ok[j] = 1.0
            trans[j] = [tr.get(p, self.transition_params[p]) for p in names]
            z[j] = zv
            for kmer, (m, s) in emis.items():
                k = kmer2idx[kmer]
                means[j, k] = m
                stdevs[j, k] = s
                mask[j, k] = 1.0
        g = multihost_utils.process_allgather(
            dict(ok=ok, trans=trans, z=z, means=means, stdevs=stdevs,
                 mask=mask))
        tot = {k: np.sum(v, axis=0) for k, v in g.items()}
        out = []
        for j in range(B):
            if tot["ok"][j] == 0:
                out.append(RuntimeError("training failed on its process"))
                continue
            tr = dict(zip(names, tot["trans"][j]))
            emis = {
                idx2kmer[k]: (tot["means"][j, k], tot["stdevs"][j, k])
                for k in np.nonzero(tot["mask"][j])[0]
            }
            out.append((tr, emis, float(tot["z"][j])))
        return out

    def _post_z(self, jobs: list, epoch: int) -> np.ndarray:
        """Post-update Z for the batch (the reference re-runs every read
        with --calcZ, train.py:248-257). Basic mode takes Z from ONE more
        batched training pass under the UPDATED parameters; resquiggle
        mode runs the exact per-read path. Multi-host: each process
        re-evaluates its
        round-robin shard; the per-slot Zs merge with a summed
        allgather (mirroring _train_batch_distributed)."""
        if self.dist is not None:
            from jax.experimental import multihost_utils

            pid, nproc = self.dist
            local_z = self._post_z_local(jobs[pid::nproc], epoch)
            z = np.zeros(len(jobs))
            z[pid::nproc] = local_z
            return np.sum(multihost_utils.process_allgather(z), axis=0)
        return self._post_z_local(jobs, epoch)

    def _post_z_local(self, jobs: list, epoch: int) -> np.ndarray:
        post_z = np.zeros(len(jobs))
        if self.mode == "basic":
            # Z is a byproduct of one more batched training pass under the
            # UPDATED parameters
            for j, r in enumerate(self._train_batch_basic(jobs)):
                if isinstance(r, Exception):
                    # same semantics as the per-read loop: Z stays 0
                    print(
                        f"No segmentation calculated for "
                        f"{jobs[j].readid} in {epoch} calcZ: {r}",
                        file=sys.stderr,
                    )
                    continue
                post_z[j] = r[2]
            return post_z
        for j, job in enumerate(jobs):
            try:
                post_z[j] = self._calc_z(job)
            except Exception as e:
                print(
                    f"No segmentation calculated for {job.readid} in "
                    f"{epoch} calcZ: {e}",
                    file=sys.stderr,
                )
        return post_z

    def _calc_z(self, job):
        model = pore_model_from_dict(self.kmer_models, self.rna)
        if self.mode == "basic":
            from dynamont_jax.models.nt_banded import run_nt_banded

            return run_nt_banded(
                job.signal, job.read, model, self.pore,
                self.transition_params, mode="calcZ", validate=False,
            ).Z
        from dynamont_jax.models.ntc import run_ntc

        return run_ntc(
            job.signal, job.read, model, self.pore, self.transition_params,
            mode="calcZ", validate=False,
        ).Z

    # -- batch update ------------------------------------------------------
    def process_batch(self, jobs: list, epoch: int) -> float | None:
        """Train one batch, pool estimates, checkpoint, return mean dZ
        (ref: train.py:205-269)."""
        self.batch_num += 1
        print("============================", file=sys.stderr)
        print(
            f"{datetime.now().strftime('%Y-%m-%d_%H-%M-%S')}: Training epoch: "
            f"{epoch}, reads: {self.reads_done}, batch: {self.batch_num}\n"
            f"{self.transition_params}",
            file=sys.stderr,
        )
        kmer_seen = set()
        pre_z = np.zeros(len(jobs))
        ok_jobs = []
        if self.dist is not None:
            results = self._train_batch_distributed(jobs)
        elif self.mode == "basic":
            results = self._train_batch_basic(jobs)
        else:
            results = self._train_batch_ntc(jobs)
        for j, job in enumerate(jobs):
            try:
                r = results[j]
                if isinstance(r, Exception):
                    raise r
                trained, new_models, z = r
            except Exception as e:
                print(
                    f"No segmentation calculated for {job.readid} in {epoch}: {e}",
                    file=sys.stderr,
                )
                continue
            self.reads_done += 1
            pre_z[j] = z
            ok_jobs.append(job)
            for p, v in trained.items():
                self.param_collector[p].add(v)
            # skip weird polyA trainings (ref: train.py:226-227)
            polya = "A" * 9 if "A" * 9 in new_models else "A" * 5
            if polya in new_models and new_models[polya][0] < 0.5:
                continue
            for kmer, (m, s) in new_models.items():
                kmer_seen.add(kmer)
                if kmer not in self.param_collector:
                    self.param_collector[kmer] = (ManagedList([m]), ManagedList([s]))
                else:
                    self.param_collector[kmer][0].add(m)
                    self.param_collector[kmer][1].add(s)
        print(f"Zs: {pre_z}", file=sys.stderr)

        self.params_csv.write(f"{epoch},{self.batch_num},{self.reads_done},")
        for p in self.transition_params:
            self.transition_params[p] = self.param_collector[p].mean()
            self.params_csv.write(f"{self.transition_params[p]},")
        for kmer in kmer_seen:
            self.kmer_models[kmer] = (
                self.param_collector[kmer][0].mean(),
                self.param_collector[kmer][1].mean(),
            )
        self.ckpt_path = join(
            self.outdir, f"trained_{epoch}_{self.batch_num}.model"
        )
        if self._is_writer:
            write_kmer_models(self.ckpt_path, self.kmer_models)
        self.params_csv.flush()

        post_z = self._post_z(jobs, epoch)
        dz = post_z - pre_z
        print(f"Z changes: {dz}", file=sys.stderr)
        delta = float(np.mean(dz))
        self.params_csv.write(f"{delta}\n")
        self.params_csv.flush()
        return delta

    def close(self):
        self.params_csv.close()
        print("Done training", file=sys.stderr)


def read_passes_filters(seq: str) -> bool:
    """Repeat-artifact filter: skip reads >=60% one nucleotide
    (ref: train.py:139-146)."""
    return not any(v >= 0.6 for v in nucleotide_ratios(seq).values())
