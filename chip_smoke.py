#!/usr/bin/env python3
"""Smoke run of dynamont-jax on one NVIDIA GPU.

Drives the main path once at production size through the entry points a
user calls, and checks every output against the repo's references:

  card       the card's name and power limit (nvidia-smi)
  kernels    each Triton kernel of the banded path compiled for the card at
             64 reads x 16k samples, compared with its XLA scan and timed
             against it (plus the basic-mode pipeline and the training
             step end to end), with each program's memory analysis
  basic      `dynamont-resquiggle --mode basic` on 256 synthetic rna002
             reads (1770 bases, 15.7k-16.3k samples: one full default
             bucket) and 16 longer ones (2600 bases, ~23.5k samples), run
             twice (cold, then with the compiled programs cached); borders
             of a subset against the exact fp64 per-read path
             (ops/nt_banded.py), and the bucket program's memory
  resquiggle `dynamont-resquiggle --mode resquiggle` on 16 such reads; two
             of them against the exact fp64 per-read path (models/ntc.py)
  train      `dynamont-train --mode basic` for two batches of 24 reads at
             --precision fp32 and fp64; the fp32 parameters against fp64
  train_trimmed  the same on reads whose signal ends ~31 bases before the
             read does (those bases get no samples of their own)

With --four it runs only the four-card paths and what they are compared
with: round-robin basic inference on 4 cards against one card, and the
psum-pooled banded Baum-Welch step on a 4-card mesh against one card.

The last line of stdout is one JSON object, printed only when every phase
passed; the script exits non-zero without it when JAX finds no GPU or any
phase fails. Measurements go to chiprun_out/chip_smoke.json.

    python chip_smoke.py            # one card
    python chip_smoke.py --four     # four cards
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

PORE = "rna002"
# the production read shape: ~1.8k bases at a mean dwell of 9 samples, so
# T ~ 16k (every read fits the 16384-row bucket); the band of 400 pads to
# B = 512
N_BASES, MEAN_DWELL = 1770, 9.0
# reads that outgrow that bucket: T ~ 23.5k, padded to 24576
N_BASES_LONG = 2600
# bases left without signal at the end of a trimmed read
TRIM_BASES = 31

RESULTS: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def make_reads(n: int, n_bases: int = N_BASES, seed0: int = 0):
    """n synthetic reads from fixed seeds: (readid, signal, 5'->3' read)."""
    from dynamont_jax.models.registry import load_model_for_pore
    from dynamont_jax.utils.synthetic import make_read

    model = load_model_for_pore(PORE)
    items = []
    for s in range(n):
        sig, read = make_read(model, n_bases=n_bases, mean_dwell=MEAN_DWELL,
                              seed=seed0 + s)
        # make_read returns the processing orientation (3'->5' behind a
        # polyA stub); the TSV carries the basecall 5'->3'
        items.append((f"read{seed0 + s}", sig, read[9:][::-1]))
    return model, items


def write_tsv(path: str, items) -> str:
    with open(path, "w") as f:
        for rid, sig, read in items:
            f.write(f"{rid}\t{rid}\t{','.join(repr(float(x)) for x in sig)}"
                    f"\t{read}\n")
    return path


def outfile(workdir: str, name: str) -> str:
    """A .csv.zst outfile where zstandard imports, plain .csv elsewhere."""
    try:
        import zstandard  # noqa: F401

        return os.path.join(workdir, name + ".csv.zst")
    except ImportError:
        return os.path.join(workdir, name + ".csv")


def read_rows(path: str) -> dict:
    """Output CSV -> {readid: [row fields]}."""
    raw = open(path, "rb").read()
    if path.endswith(".zst"):
        import io

        import zstandard

        raw = zstandard.ZstdDecompressor().stream_reader(
            io.BytesIO(raw)).read()
    lines = raw.decode().splitlines()
    assert lines[0].startswith("readid,signalid,start,end"), lines[0]
    rows: dict = {}
    for line in lines[1:]:
        f = line.split(",")
        rows.setdefault(f[0], []).append(f)
    return rows


def check_cli_output(path: str, items) -> dict:
    """Every read segmented, none in the .errors sidecar."""
    from os.path import splitext

    rows = read_rows(path)
    want = {rid for rid, _, _ in items}
    missing = sorted(want - set(rows))
    errfile = splitext(splitext(path)[0])[0] + ".errors"
    errors = open(errfile).read().splitlines() if os.path.exists(errfile) \
        else []
    assert not missing, f"{len(missing)} reads missing: {missing[:5]}"
    assert not errors, f"{len(errors)} reads in .errors: {errors[:3]}"
    return rows


def compare_rows(got: list, want: list, prob_tol: float,
                 examples: list | None = None) -> tuple[int, int]:
    """(mismatched rows, rows): a row matches when its borders, base
    position, state and polish k-mer are equal and its posterior is within
    prob_tol. The first few mismatches go to `examples`."""
    assert len(got) == len(want), (len(got), len(want))
    bad = 0
    for g, w in zip(got, want):
        same = (g[2:8] == w[2:8] and g[9:] == w[9:]
                and abs(float(g[8]) - float(w[8])) <= prob_tol)
        if not same and examples is not None and len(examples) < 4:
            examples.append((g, w))
        bad += 0 if same else 1
    return bad, len(got)


def reference_rows(tsv: str, readids, run, quantize: bool) -> dict:
    """CSV rows of the exact per-read path for the given reads, formatted
    through the CLI's own output conventions. `run(signal, read)` returns
    the segment list. With `quantize` the signal is first snapped to the
    int16 grid the basic-mode wire format carries, so both sides see the
    same samples. A float32 matmul may run in TF32 on the GPU, so the
    reference runs at the highest matmul precision."""
    import jax
    import numpy as np

    from dynamont_jax.io import output as out_io
    from dynamont_jax.io import readers
    from dynamont_jax.ops.nt_banded_device import quantize_signal

    out = {}
    for job in readers.generate_tsv_jobs(tsv, rna=True):
        if job.readid not in readids:
            continue
        sig = job.signal
        if quantize:
            dac, a, b = quantize_signal(sig)
            sig = dac.astype(np.float64) * a + b
        with jax.default_matmul_precision("highest"):
            segs = run(sig, job.read)
        text = out_io.format_segments_csv(
            job.readid, job.signalid, segs, job.sig_offset,
            len(job.signal) + job.sig_offset, job.read, 5, True)
        out[job.readid] = [ln.split(",") for ln in
                           text.decode().splitlines()]
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def _timeit(fn, *args, reps: int = 3):
    """Compiles and runs once, then times `reps` runs to completion."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, {"first_s": first, "best_s": min(times),
                 "times_s": sorted(times)}


def _memory(fn, *args) -> dict:
    """The compiled program's memory analysis (bytes)."""
    import jax

    ma = jax.jit(fn).lower(*args).compile().memory_analysis()
    if ma is None:
        return {}
    return {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(ma, k)}


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def phase_kernels(n_reads: int = 64, n_bases: int = N_BASES,
                  n_train: int = 24, interpret: bool = False,
                  reps: int = 3) -> dict:
    """Each banded kernel against its XLA scan: same inputs, compared with
    the tolerances of tests/test_pallas_kernels.py (Z values rtol 1e-6,
    Viterbi choice bits agree on >= 99.9% of live cells, walk starts
    identical, medians within 1e-6), and timed. Then the basic-mode
    pipeline and the fp32 training step end to end against their XLA
    forms, and the fp64 training step that --precision fp64 runs."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dynamont_jax.constants import NT_TRANSITIONS
    from dynamont_jax.models.packing import t_pad_ladder
    from dynamont_jax.ops import nt_banded_batch as bb
    from dynamont_jax.ops import nt_banded_device as dv
    from dynamont_jax.ops import nt_banded_pallas as pk
    from dynamont_jax.ops import nt_banded_train as bt
    from dynamont_jax.utils.kmer import seq_to_kmer_ids

    model, items = make_reads(n_reads, n_bases)
    tr = NT_TRANSITIONS[PORE]
    LM, LE = math.log(tr["m1"]), math.log(tr["e2"])
    kids = [seq_to_kmer_ids(_proc(r), model.kmer_size, model.alphabet_size)
            for _, _, r in items]
    sigs = [s for _, s, _ in items]
    t_pad = t_pad_ladder(max(len(s) for s in sigs) + 1, 512)
    out: dict = {}

    def batch_of(n, dtype):
        return bb.prepare_batch(sigs[:n], kids[:n], model.means,
                                model.stdevs, dtype=dtype, t_pad_to=t_pad)

    with jax.enable_x64(False):
        b = batch_of(n_reads, jnp.float32)
        args = (b.sig, b.mu_pad, b.c1_pad, b.c2_pad, b.bstart, b.T, b.N,
                b.bw)
        mk = lambda *a: bb.BandedBatch(*a, b.pad, b.B)  # noqa: E731
        T = np.asarray(b.T)
        bw = np.asarray(b.bw)
        r = np.arange(n_reads)
        N_max = bb.round_up(int(np.asarray(b.N).max()), 128)
        out["shape"] = {"reads": n_reads, "T_pad": t_pad, "B": b.B}

        def vm(fn, *a):
            return jax.vmap(fn)(*a)

        kern = {
            "backward": lambda *a: pk.backward(mk(*a), LM, LE, interpret),
            "forward": lambda *a: pk.forward(mk(*a), LM, LE, interpret),
        }
        scan = {
            "backward": lambda *a: vm(bb._backward_single(mk(*a), LM, LE),
                                      *a[:5], a[7], a[6], a[5]),
            "forward": lambda *a: vm(bb._forward_single(mk(*a), LM, LE),
                                     *a[:5], a[7], a[6]),
        }
        res = {}
        for name in ("backward", "forward"):
            res[name, "k"], out[name + "_kernel"] = _timeit(
                jax.jit(kern[name]), *args, reps=reps)
            res[name, "s"], out[name + "_scan"] = _timeit(
                jax.jit(scan[name]), *args, reps=reps)
        zb_s = np.asarray(res["backward", "s"][1])[r, 0, bw + 1]
        zf_s = np.asarray(res["forward", "s"][1])[r, T - 1, bw + 1]
        np.testing.assert_allclose(np.asarray(res["backward", "k"][2]), zb_s,
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(res["forward", "k"][2]), zf_s,
                                   rtol=1e-6)
        bM, bE, Zb = res["backward", "k"]
        del res

        def fv_scan(bM, bE, Zb, *a):
            bt_ = mk(*a)
            fM, fE = vm(bb._forward_single(bt_, LM, LE), *a[:5], a[7], a[6])
            LPM = fM + bM - Zb[:, None, None]
            LPE = fE + bE - Zb[:, None, None]
            ch = vm(bb._viterbi_single(bt_), LPM, LPE, bt_.bstart, bt_.bw,
                    bt_.N)
            lse = bb.row_lse(LPM, LPE)
            return LPM - lse, LPE - lse, ch

        (sLPM, sLPE, sch), out["fwd_vit_scan"] = _timeit(
            jax.jit(fv_scan), bM, bE, Zb, *args, reps=reps)
        fv = jax.jit(lambda bM, bE, Zb, *a: pk.fwd_vit(
            mk(*a), bM, bE, Zb, LM, LE, interpret))
        # fwd_vit writes its log posteriors over bM/bE: time it on copies
        (LPM, LPE, ch, Zf), out["fwd_vit_kernel"] = _timeit(
            lambda *a: fv(jnp.copy(bM), jnp.copy(bE), *a), Zb, *args,
            reps=reps)
        np.testing.assert_allclose(np.asarray(Zf), zf_s, rtol=1e-6)
        chk, chs = np.asarray(ch) != 0, np.asarray(sch)
        agree = min(float((chk[i, :T[i]] == chs[i, :T[i]]).mean())
                    for i in range(n_reads))
        out["fwd_vit_choice_agreement_min"] = agree
        assert agree >= 0.999, agree

        prob = lambda lp: jnp.clip(jnp.nan_to_num(  # noqa: E731
            jnp.exp(lp), nan=0.0, posinf=0.0), 0.0, 1.0)
        sPM, sPE = prob(sLPM), prob(sLPE)
        del sLPM, sLPE
        walk_k = jax.jit(lambda LPM, LPE, ch, *a: pk.walk(
            LPM, LPE, ch, mk(*a), N_max, interpret,
            bb.row_lse(LPM, LPE)[..., 0]))
        walk_s = jax.jit(lambda PM, PE, ch, *a: vm(
            dv._walk_single(b.B, N_max), PM, PE, ch, a[4], a[5], a[6], a[7]))
        (st_k, med_k), out["walk_kernel"] = _timeit(walk_k, LPM, LPE, ch,
                                                    *args, reps=reps)
        (st_s, med_s), out["walk_scan"] = _timeit(walk_s, sPM, sPE,
                                                  jnp.asarray(chs), *args,
                                                  reps=reps)
        np.testing.assert_array_equal(np.asarray(st_k), np.asarray(st_s))
        np.testing.assert_allclose(np.asarray(med_k), np.asarray(med_s),
                                   atol=1e-6)
        del bM, bE, LPM, LPE, ch, sPM, sPE, sch

        # the basic-mode device pipeline end to end: kernels vs scans
        seg_k = lambda *a: pk.banded_segment(  # noqa: E731
            mk(*a), N_max, LM, LE, interpret)

        def seg_s(*a):
            bt_ = mk(*a)
            rs = bb.banded_batch_run(bt_, LM, LE)
            st, med = vm(dv._walk_single(b.B, N_max), rs.PM, rs.PE,
                         rs.choices, bt_.bstart, bt_.T, bt_.N, bt_.bw)
            return rs.Zf, rs.Zb, st, med

        out["segment_kernel_memory"] = _memory(seg_k, *args)
        (Zf_k, _, st_k, _), out["segment_kernel"] = _timeit(
            jax.jit(seg_k), *args, reps=reps)
        out["segment_kernel_peak_bytes"] = _peak_bytes()
        out["segment_scan_memory"] = _memory(seg_s, *args)
        (Zf_s, _, st_s, _), out["segment_scan"] = _timeit(
            jax.jit(seg_s), *args, reps=reps)
        np.testing.assert_array_equal(np.asarray(st_k), np.asarray(st_s))
        out["segment_reads_per_s_kernel"] = \
            n_reads / out["segment_kernel"]["best_s"]
        out["segment_reads_per_s_scan"] = \
            n_reads / out["segment_scan"]["best_s"]

        # the fp32 training step: kernels vs the jitted scan form
        n_tr = min(n_train, n_reads)
        bt32 = batch_of(n_tr, jnp.float32)
        kid_pad = np.zeros((n_tr, max(len(k) for k in kids[:n_tr])),
                           np.int32)
        for i, k in enumerate(kids[:n_tr]):
            kid_pad[i, :len(k)] = k
        kid_pad = jnp.asarray(kid_pad)
        K = model.num_kmers
        rk, out["train_fp32_kernel"] = _timeit(
            lambda: bt.banded_batch_train_fast(bt32, LM, LE, kid_pad, K,
                                               interpret), reps=reps)
        rs, out["train_fp32_scan"] = _timeit(
            lambda: bb.banded_batch_train_jit(bt32, LM, LE, kid_pad, K),
            reps=reps)
        out["train_fp32_kernel_vs_scan_m1_maxrel"] = float(np.max(np.abs(
            np.asarray(rk.m1) / np.asarray(rs.m1) - 1)))
        out["train_fp32_kernel_vs_scan_e2_maxrel"] = float(np.max(np.abs(
            np.asarray(rk.e2) / np.asarray(rs.e2) - 1)))
        assert np.array_equal(np.asarray(rk.kmer_mask),
                              np.asarray(rs.kmer_mask))
    with jax.enable_x64(True):
        bt64 = batch_of(n_tr, jnp.float64)
        _, out["train_fp64_scan"] = _timeit(
            lambda: bb.banded_batch_train_jit(bt64, LM, LE, kid_pad, K),
            reps=reps)
    out["peak_bytes"] = _peak_bytes()
    return out


def _proc(read_5to3: str) -> str:
    from dynamont_jax.utils.signal import prepare_read_sequence

    return prepare_read_sequence(read_5to3, True)


def phase_basic(workdir: str, n_reads: int = 256, n_long: int = 16,
                n_bases: int = N_BASES, n_bases_long: int = N_BASES_LONG,
                n_ref: int = 3, interpret: bool = False) -> dict:
    """dynamont-resquiggle --mode basic with its default bucketing: n_reads
    production-length reads (one full bucket of the CLI's default 256
    reads) and n_long longer ones (a second bucket shape), run twice — the
    second run finds the bucket programs in the compile cache. Against the
    exact fp64 path (ops/nt_banded.py) a row must carry the same borders,
    base and state, with its posterior within 2e-3
    (tests/test_device_pipeline.py's fp32 bound), and at most 1 row in 50
    may differ (fp32 near-ties: the rule of tests/test_ntc_batch.py); the
    references are the first n_ref reads and the first long one. Also the
    memory analysis of the banded kernel program at the full bucket's
    shape."""
    import jax
    import jax.numpy as jnp

    from dynamont_jax.cli import resquiggle
    from dynamont_jax.constants import NT_TRANSITIONS
    from dynamont_jax.models.nt_banded import run_nt_banded
    from dynamont_jax.models.packing import t_pad_ladder
    from dynamont_jax.ops import nt_banded_batch as bb
    from dynamont_jax.ops import nt_banded_pallas as pk
    from dynamont_jax.utils.kmer import seq_to_kmer_ids

    model, items = make_reads(n_reads, n_bases)
    _, long_items = make_reads(n_long, n_bases_long, seed0=1000)
    tsv = write_tsv(os.path.join(workdir, "basic.tsv"), items + long_items)
    out: dict = {"reads": n_reads + n_long}
    for run in ("cold", "warm"):
        path = outfile(workdir, "basic_" + run)
        t0 = time.perf_counter()
        resquiggle.main(["--tsv", tsv, "-o", path, "--mode", "basic",
                         "-p", PORE])
        out[run + "_wall_s"] = time.perf_counter() - t0
        out[run + "_reads_per_s"] = out["reads"] / out[run + "_wall_s"]
        rows = check_cli_output(path, items + long_items)
    out["peak_bytes"] = _peak_bytes()
    ref_items = items[:n_ref] + long_items[:1]
    ref_ids = {rid for rid, _, _ in ref_items}
    ref = reference_rows(tsv, ref_ids, lambda sig, read: run_nt_banded(
        sig, read, model, PORE).segments, quantize=True)
    bad = total = 0
    examples: list = []
    for rid in sorted(ref_ids):
        b, n = compare_rows(rows[rid], ref[rid], 2e-3, examples)
        bad, total = bad + b, total + n
    assert bad <= max(1, total // 50), \
        f"{bad}/{total} rows differ, e.g. (got, want) {examples}"
    out.update(ref_reads=len(ref_ids), ref_rows=total,
               ref_rows_differing=bad)

    tr = NT_TRANSITIONS[PORE]
    sigs = [sig for _, sig, _ in items]
    kids = [seq_to_kmer_ids(_proc(r), model.kmer_size, model.alphabet_size)
            for _, _, r in items]
    t_pad = t_pad_ladder(max(len(sg) for sg in sigs) + 1, 512)
    N_max = bb.round_up(int(max(len(k) for k in kids)) + 1, 128)
    with jax.enable_x64(False):
        b = bb.prepare_batch(sigs, kids, model.means, model.stdevs,
                             dtype=jnp.float32, t_pad_to=t_pad)
        out["bucket"] = {"reads": n_reads, "T_pad": t_pad, "B": b.B}
        out["bucket_kernel_memory"] = _memory(
            lambda *a: pk.banded_segment(
                bb.BandedBatch(*a, b.pad, b.B), N_max, math.log(tr["m1"]),
                math.log(tr["e2"]), interpret),
            b.sig, b.mu_pad, b.c1_pad, b.c2_pad, b.bstart, b.T, b.N, b.bw)
    return out


def phase_resquiggle(workdir: str, n_reads: int = 16,
                     n_bases: int = N_BASES, n_ref: int = 2) -> dict:
    """dynamont-resquiggle --mode resquiggle. Against the exact fp64 path
    (models/ntc.run_ntc): the rule of tests/test_ntc_batch.py's fp32 test
    — same row count, a row matches on borders, state and polish k-mer
    with its posterior within 5e-3, and at most 1 row in 50 may differ
    (fp32 near-ties)."""
    from dynamont_jax.cli import resquiggle
    from dynamont_jax.models.ntc import run_ntc

    model, items = make_reads(n_reads, n_bases, seed0=100)
    tsv = write_tsv(os.path.join(workdir, "resquiggle.tsv"), items)
    out = outfile(workdir, "resquiggle")
    t0 = time.perf_counter()
    resquiggle.main(["--tsv", tsv, "-o", out, "--mode", "resquiggle",
                     "-p", PORE])
    wall = time.perf_counter() - t0
    rows = check_cli_output(out, items)
    ref_ids = {rid for rid, _, _ in items[:n_ref]}
    t0 = time.perf_counter()
    ref = reference_rows(tsv, ref_ids, lambda sig, read: run_ntc(
        sig, read, model, PORE).segments, quantize=False)
    ref_wall = time.perf_counter() - t0
    bad = total = 0
    examples: list = []
    for rid in sorted(ref_ids):
        b, n = compare_rows(rows[rid], ref[rid], 5e-3, examples)
        bad, total = bad + b, total + n
    assert bad <= max(1, total // 50), \
        f"{bad}/{total} rows differ, e.g. (got, want) {examples}"
    return {"reads": n_reads, "wall_s": wall, "reads_per_s": n_reads / wall,
            "ref_reads": len(ref_ids), "ref_rows": total,
            "ref_rows_differing": bad, "ref_wall_s": ref_wall}


def _train_fp32_vs_fp64(workdir: str, name: str, items,
                        batch_size: int) -> dict:
    """dynamont-train --mode basic at fp32 and at fp64 over the same
    batches. Each run must write params.csv and a trained model per batch.
    Returns the walls, the last batch's transitions per precision, and the
    fp32 k-mer levels' absolute deviations from fp64 against their bound
    (1e-3 absolute + 1e-3 relative)."""
    import jax
    import numpy as np

    from dynamont_jax.cli import train
    from dynamont_jax.utils.pore_model import read_kmer_models

    tsv = write_tsv(os.path.join(workdir, name + ".tsv"), items)
    n_batches = len(items) // batch_size
    out: dict = {}
    params, models = {}, {}
    x64 = jax.config.jax_enable_x64
    try:
        for prec in ("fp32", "fp64"):
            d = os.path.join(workdir, f"{name}_{prec}")
            t0 = time.perf_counter()
            train.main(["--tsv", tsv, "-o", d, "-p", PORE, "--mode", "basic",
                        "-q", "0", "--batch_size", str(batch_size),
                        "--precision", prec])
            out[prec + "_wall_s"] = time.perf_counter() - t0
            lines = open(os.path.join(d, "params.csv")).read().splitlines()
            assert len(lines) == 1 + n_batches, lines
            head = lines[0].split(",")
            last = dict(zip(head, lines[-1].split(",")))
            params[prec] = {k: float(last[k]) for k in ("m1", "e2")}
            path = os.path.join(d, f"trained_0_{n_batches}.model")
            assert os.path.exists(path), path
            models[prec] = read_kmer_models(path)
    finally:
        jax.config.update("jax_enable_x64", x64)
    for k in ("m1", "e2"):
        out[k + "_rel"] = abs(params["fp32"][k] / params["fp64"][k] - 1)
    out["params"] = params
    kmers = sorted(models["fp64"])
    m32 = np.array([models["fp32"][k] for k in kmers])
    m64 = np.array([models["fp64"][k] for k in kmers])
    dev = np.abs(m32 - m64)
    out["kmer_mean_maxabs"] = float(dev[:, 0].max())
    out["kmer_stdev_maxabs"] = float(dev[:, 1].max())
    over = np.any(dev > 1e-3 * np.abs(m64) + 1e-3, axis=1)
    out["kmers"] = len(kmers)
    out["kmers_beyond_bound"] = int(over.sum())
    out["worst_kmers"] = [
        (kmers[i], float(m32[i, 0]), float(m64[i, 0]))
        for i in np.argsort(-dev[:, 0])[:3]]
    return out


def phase_train(workdir: str, n_reads: int = 48, n_bases: int = N_BASES,
                batch_size: int = 24) -> dict:
    """dynamont-train at fp32 against fp64 on reads whose signal covers
    every base: the fp32 transitions must match fp64 within 1e-3 relative
    (the bound of tests/test_train_fast.py's trainer test), and every fp32
    k-mer mean and stdev within 1e-3 absolute + 1e-3 relative: per-read
    fp32 estimates drift from fp64 with read length (up to 1.6e-4 at
    T = 8k), because the fp32 forward and backward sums drift by tenths of
    a nat over 16k steps."""
    _, items = make_reads(n_reads, n_bases, seed0=200)
    out = _train_fp32_vs_fp64(workdir, "train", items, batch_size)
    assert out["m1_rel"] <= 1e-3 and out["e2_rel"] <= 1e-3, out
    assert out["kmers_beyond_bound"] == 0, out
    return out


def phase_train_trimmed(workdir: str, n_reads: int = 48,
                        n_bases: int = N_BASES, batch_size: int = 24,
                        trim_bases: int = TRIM_BASES) -> dict:
    """The same reads as phase_train with trim_bases * MEAN_DWELL samples
    cut from the end of each signal, so that the signal runs out about
    trim_bases bases before the basecall does (a case real reads have).
    The alignment of those bases is ambiguous: per-read fp32 k-mer
    estimates there differ from fp64 by up to 2e-3 on the card, and a base
    squeezed to one sample gives a k-mer estimate of variance ~1e-9, which
    fp32 rounds to 0 (ops/nt_banded_train.kmer_moments keeps it). The
    transitions keep the 1e-3 relative bound; a pooled k-mer mean or stdev
    may leave the 1e-3 + 1e-3 relative bound for at most 1 k-mer in 100
    (the near-tie rule of the inference phases), and none by more than
    5e-3."""
    _, items = make_reads(n_reads, n_bases, seed0=200)
    cut = round(trim_bases * MEAN_DWELL)
    items = [(rid, sig[:len(sig) - cut], read) for rid, sig, read in items]
    out = _train_fp32_vs_fp64(workdir, "train_trimmed", items, batch_size)
    out["samples_cut"] = cut
    assert out["m1_rel"] <= 1e-3 and out["e2_rel"] <= 1e-3, out
    assert out["kmers_beyond_bound"] <= max(1, out["kmers"] // 100), out
    assert max(out["kmer_mean_maxabs"], out["kmer_stdev_maxabs"]) <= 5e-3, \
        out
    return out


def phase_four_inference(n_devices: int = 4, n_reads: int = 64,
                         n_bases: int = N_BASES,
                         batch_size: int = 16) -> dict:
    """Round-robin basic inference over n devices (models/batch.py) against
    one device: every device gets buckets, and each read's Z, segment
    starts and medians are identical (the same program on the same
    inputs)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dynamont_jax.models.batch import BandedBatchEngine, BatchItem

    devs = jax.local_devices()[:n_devices]
    assert len(devs) == n_devices, devs
    model, items = make_reads(n_reads, n_bases)
    batch = [BatchItem(sig, _proc(read)) for _, sig, read in items]
    outs, walls = {}, {}
    for n, dv_ in ((1, devs[:1]), (n_devices, devs)):
        eng = BandedBatchEngine(model, PORE, dtype=jnp.float32,
                                batch_size=batch_size, devices=dv_)
        eng.run(batch)  # compile on every device
        t0 = time.perf_counter()
        outs[n] = eng.run(batch)
        walls[n] = time.perf_counter() - t0
        assert len(eng.profile["device_buckets"]) == n, eng.profile
    for a, b in zip(outs[1], outs[n_devices]):
        assert a.error is None and b.error is None, (a.error, b.error)
        assert a.Z == b.Z
        for x, y in zip(a.summaries[:2], b.summaries[:2]):
            assert np.array_equal(np.asarray(x), np.asarray(y))
    return {"reads": n_reads, "wall_1_s": walls[1],
            f"wall_{n_devices}_s": walls[n_devices],
            "speedup": walls[1] / walls[n_devices]}


def phase_four_train(n_devices: int = 4, n_reads: int = 24,
                     n_bases: int = N_BASES) -> dict:
    """The psum-pooled banded Baum-Welch step (parallel/train_step.py) on an
    n-device mesh against a one-device mesh: per-read estimates and pooled
    sums within 1e-5 relative. Each read runs the same computation, but
    XLA orders the fp32 reductions over a read's T x B cells differently
    at another shard width (up to 5e-6 relative on the cards), and psum
    adds the shards in another order."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dynamont_jax.constants import NT_TRANSITIONS
    from dynamont_jax.ops import nt_banded_batch as bb
    from dynamont_jax.parallel import make_mesh, make_sharded_train_step
    from dynamont_jax.parallel.train_step import shard_batch_for_mesh
    from dynamont_jax.utils.kmer import seq_to_kmer_ids

    model, items = make_reads(n_reads, n_bases, seed0=300)
    kids = [seq_to_kmer_ids(_proc(r), model.kmer_size, model.alphabet_size)
            for _, _, r in items]
    tr = NT_TRANSITIONS[PORE]
    res, walls = {}, {}
    with jax.enable_x64(False):
        batch = bb.prepare_batch([s for _, s, _ in items], kids,
                                 model.means, model.stdevs,
                                 dtype=jnp.float32, t_pad_to=2048)
        kid_pad = np.zeros((n_reads, max(len(k) for k in kids)), np.int32)
        for i, k in enumerate(kids):
            kid_pad[i, :len(k)] = k
        for n in (1, n_devices):
            mesh = make_mesh(n)
            sb, sk, _ = shard_batch_for_mesh(batch, kid_pad, mesh)
            step = make_sharded_train_step(mesh, tr["m1"], tr["e2"],
                                           model.num_kmers, pad=sb.pad,
                                           B=sb.B, dtype=jnp.float32)
            jax.block_until_ready(step(sb, sk))
            t0 = time.perf_counter()
            res[n] = jax.block_until_ready(step(sb, sk))
            walls[n] = time.perf_counter() - t0
    one, many = res[1], res[n_devices]
    assert int(many.pooled.n_valid) == n_reads
    for f in ("m1", "e2", "means", "stdevs"):
        np.testing.assert_allclose(
            np.asarray(getattr(many.per_read, f))[:n_reads],
            np.asarray(getattr(one.per_read, f))[:n_reads], rtol=1e-5)
    for f in ("m1_sum", "e2_sum", "n_valid", "mean_sum", "stdev_sum",
              "kmer_count", "z_sum"):
        np.testing.assert_allclose(np.asarray(getattr(many.pooled, f)),
                                   np.asarray(getattr(one.pooled, f)),
                                   rtol=1e-5)
    return {"reads": n_reads, "step_1_s": walls[1],
            f"step_{n_devices}_s": walls[n_devices]}


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def run_phase(name: str, fn, *args, **kw) -> bool:
    log(f"phase {name}: start")
    t0 = time.perf_counter()
    try:
        RESULTS[name] = fn(*args, **kw)
        ok = True
    except Exception as e:
        traceback.print_exc()
        RESULTS[name] = {"error": f"{type(e).__name__}: {e}"[:2000]}
        ok = False
    RESULTS[name + "_wall_s"] = time.perf_counter() - t0
    log(f"phase {name}: {'ok' if ok else 'FAILED'} "
        f"{json.dumps(RESULTS[name], default=str)}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths (needs 4 GPUs)")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX sees {devices[0].platform})",
              file=sys.stderr)
        return 2
    from dynamont_jax.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = card_line()
    log(f"card: {card}")
    RESULTS["card"] = card
    n = 4 if args.four else 1
    if len(devices) < n:
        print(f"chip_smoke: needs {n} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    ok = True
    with tempfile.TemporaryDirectory() as workdir:
        if args.four:
            ok &= run_phase("four_inference", phase_four_inference, 4)
            ok &= run_phase("four_train", phase_four_train, 4)
        else:
            # basic first: the peak bytes it reports are its own
            ok &= run_phase("basic", phase_basic, workdir)
            ok &= run_phase("kernels", phase_kernels)
            ok &= run_phase("resquiggle", phase_resquiggle, workdir)
            ok &= run_phase("train", phase_train, workdir)
            ok &= run_phase("train_trimmed", phase_train_trimmed, workdir)
    os.makedirs("chiprun_out", exist_ok=True)
    name = "chip_smoke_four.json" if args.four else "chip_smoke.json"
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump(RESULTS, f, indent=1, default=str)
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
