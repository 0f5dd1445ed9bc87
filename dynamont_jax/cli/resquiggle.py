"""dynamont-resquiggle: batch segmentation of a sequencing run.

JAX replacement for the reference CLI (ref: src/python/segmentation/
segment.py). Reads come from a dorado BAM + raw-file directory (pysam/
read5_ont) or a plain TSV (--tsv); instead of per-read C++ child processes
the reads are bucketed and segmented on-device by the batched banded engine
(basic mode) or the NTC engine (resquiggle mode); results stream to a
CSV — zstd-compressed for a .zst outfile — with the reference's column
layout and `.errors` sidecar semantics.
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser

from dynamont_jax.constants import PORES


def build_parser() -> ArgumentParser:
    p = ArgumentParser(prog="dynamont-resquiggle")
    p.add_argument("-r", "--raw", metavar="DIR", default=None,
                   help="Path to raw ONT data (pod5/fast5/slow5 directory)")
    p.add_argument("-b", "--basecalls", metavar="BAM", default=None,
                   help="Basecalls of ONT training data as .bam file")
    p.add_argument("--tsv", metavar="TSV", default=None,
                   help="Plain-TSV read source (readid, signalid, signal, read)")
    p.add_argument("-o", "--outfile", metavar="CSV", required=True,
                   help="Outfile path (.csv.zst, or .csv for plain text)")
    p.add_argument("--mode", choices=["basic", "resquiggle"], required=True)
    p.add_argument("-p", "--pore", required=True, choices=list(PORES))
    p.add_argument("--model_path", default=None)
    p.add_argument("-q", "--qscore", type=float, default=0.0)
    p.add_argument("--batch_size", type=int, default=None,
                   help="reads per device launch (default: 256 basic — "
                        "one GPU program per read, so a bucket must be wide "
                        "enough to fill the card; a bucket holds at most "
                        "2^22 samples — and 16 resquiggle)")
    p.add_argument("-t", "--processes", type=int, default=None,
                   help="accepted for reference compatibility; device batching replaces the process pool")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host run: initialize jax.distributed and take "
                        "every process_count-th read (round-robin shard of the "
                        "job stream; output files get a .rank<k> suffix)")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted run: reads already in the "
                        "output CSV are skipped, new results are appended "
                        "(errored reads are retried)")
    p.add_argument("--ntc-native-9mer", action="store_true",
                   help="resquiggle mode with a >5-mer model: run NTC at "
                   "native K (true 9-mer polish calls, ref: "
                   "NTC_main.cpp:95-99) instead of the reduced 5-mer "
                   "tables; memory-heavy, reads are bucketed singly")
    p.add_argument("--profile", action="store_true",
                   help="print engine wall-clock accounting (dispatch vs "
                        "device-wait per bucket) to stderr at the end")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.tsv is None and (args.raw is None or args.basecalls is None):
        print("provide either --tsv or both --raw and --basecalls", file=sys.stderr)
        raise SystemExit(2)

    from dynamont_jax.compile_cache import enable_compile_cache
    from dynamont_jax.constants import is_rna
    from dynamont_jax.io import output as out_io
    from dynamont_jax.io import readers
    from dynamont_jax.models.registry import load_model_for_pore

    # persistent XLA cache: without it every invocation pays the full
    # bucket-program compile
    enable_compile_cache()

    rna = is_rna(args.pore)
    model = load_model_for_pore(args.pore, args.model_path)

    # multi-host data parallelism: reads are embarrassingly parallel, so each
    # process handles a round-robin shard of the job stream and writes its
    # own output file (no cross-host tensor traffic; SURVEY.md §2.4)
    rank, world = 0, 1
    outfile = args.outfile
    if args.distributed:
        from dynamont_jax.parallel.mesh import init_distributed
        import jax

        init_distributed(required=True)
        rank, world = jax.process_index(), jax.process_count()
        if world > 1:
            outfile = f"{args.outfile}.rank{rank}"
    done: set = set()
    resume = False
    if args.resume:
        import os

        if os.path.exists(outfile):
            done = out_io.prepare_resume(outfile)
            resume = True
            print(f"resume: skipping {len(done)} already-segmented reads",
                  file=sys.stderr)
    writer = out_io.SegmentationWriter(outfile, append=resume)

    def jobs():
        if args.tsv is not None:
            source = readers.generate_tsv_jobs(args.tsv, rna, args.qscore)
            for i, job in enumerate(source):
                if i % world == rank and job.readid not in done:
                    yield job
        else:
            for i, raw in enumerate(
                readers.generate_bam_jobs(args.raw, args.basecalls, args.qscore)
            ):
                if i % world != rank or raw[6] in done:
                    continue
                try:
                    yield readers.materialize_bam_job(raw, rna)
                except Exception as e:  # unreadable raw data -> sidecar
                    writer.put_error(
                        f"error: raw read failed, {e}\tRid: {raw[6]}\tSid: {raw[7]}"
                    )

    try:
        if args.mode == "basic":
            _run_basic(args, model, jobs(), writer, rna)
        else:
            _run_resquiggle(args, model, jobs(), writer, rna)
    finally:
        writer.close()


def _emit(writer, job, segments, model, rna, summaries=None):
    from dynamont_jax.io import output as out_io

    if summaries is not None:
        # native fast path straight from the device summaries (byte-
        # identical to the Python formatter; ~40x less host time per read)
        from dynamont_jax.native import summaries_csv_native

        starts_row, medians_row, N, kmer_size = summaries
        data = summaries_csv_native(
            f"{job.readid},{job.signalid},", starts_row, medians_row, N,
            job.read, kmer_size, rna, job.sig_offset,
            len(job.signal) + job.sig_offset,
        )
        if data is not None:
            writer.put_result(data)
            return
    writer.put_result(out_io.format_segments_csv(
        job.readid, job.signalid, segments, job.sig_offset,
        len(job.signal) + job.sig_offset, job.read, model.kmer_size, rna,
    ))


def _run_basic(args, model, jobs, writer, rna):
    import jax.numpy as jnp

    from dynamont_jax.models.batch import BandedBatchEngine

    eng = BandedBatchEngine(
        model, args.pore, dtype=jnp.float32,
        batch_size=args.batch_size or 256,
    )
    _pump_engine(args, eng, jobs, writer, rna, model, err_prefix="error: 3, ")


def _run_resquiggle(args, model, jobs, writer, rna):
    """NTC (resquiggle) mode through the batched device engine; cap-overflow
    reads transparently re-run on the exact per-read path inside the
    engine (models/ntc_batch)."""
    import jax.numpy as jnp

    from dynamont_jax.models.ntc_batch import NTCBatchEngine

    eng = NTCBatchEngine(
        model, args.pore, dtype=jnp.float32,
        batch_size=args.batch_size or 16,
        native_kmer=args.ntc_native_9mer,
    )
    _pump_engine(args, eng, jobs, writer, rna, model, err_prefix="error: ")


def _dump_failed_input(job) -> str:
    """Repro dump for a read that crashed the engine: the reference stdin
    format (signal csv line + read line), like the reference's training
    repro dump (ref: FileIO.py:281-283). Returns the dump path."""
    path = f"failed_input_{job.readid}.txt"
    with open(path, "w") as fh:
        fh.write(",".join(repr(float(v)) for v in job.signal))
        fh.write("\n")
        fh.write(job.read)
        fh.write("\n")
    return path


def _pump_engine(args, eng, jobs, writer, rna, model, err_prefix: str):
    """Stream jobs through the engine with a rolling dispatch window:
    chunk i+1 is dispatched BEFORE chunk i is collected, so the device
    pipeline never drains between chunks (the reference's pipeline never
    idles between reads either, ref: segment.py:292-317). Live progress —
    a tqdm bar with reads/s and an error-count postfix, ref:
    segment.py:89-107 — is owned by the SegmentationWriter thread."""
    from collections import deque

    from dynamont_jax.models.batch import BatchItem

    chunk: list = []
    CHUNK = (args.batch_size or 256) * 4
    # rolling window: up to INFLIGHT chunks dispatched ahead of collection
    # (queued launches hold only their input/output buffers — the DP
    # working set is per-launch — so the device-memory cost of a deep
    # window is small); it hides the per-bucket transfer latency
    INFLIGHT = 3
    window: deque = deque()

    def emit(outs):
        for o in outs:
            job = o.item.meta
            if o.error is not None:
                writer.put_error(
                    f"{err_prefix}{o.error}\tT: {len(job.signal)}"
                    f"\tN: {len(job.read)}\tRid: {job.readid}"
                    f"\tSid: {job.signalid}"
                )
            else:
                _emit(writer, job, o.segments, model, rna,
                      summaries=o.summaries)

    def isolate(part):
        """Re-run each read of a crashed chunk singly so one pathological
        read cannot take down its neighbours; a read that still crashes
        the engine gets a repro dump (reference stdin format) + a sidecar
        error line."""
        for job in part:
            try:
                emit(eng.run([BatchItem(job.signal, job.read, job)]))
            except Exception as e:
                path = _dump_failed_input(job)
                writer.put_error(
                    f"error: engine exception, {e}\tT: {len(job.signal)}"
                    f"\tN: {len(job.read)}\tRid: {job.readid}"
                    f"\tSid: {job.signalid}\tdump: {path}"
                )

    def collect_safe(handle, part):
        try:
            emit(eng.collect(handle))
        except Exception as e:  # unexpected engine failure
            print(f"engine exception on a {len(part)}-read chunk: {e}; "
                  "isolating per read", file=sys.stderr)
            isolate(part)

    def submit():
        nonlocal chunk
        part = chunk
        chunk = []
        try:
            handle = eng.dispatch(
                [BatchItem(j.signal, j.read, j) for j in part])
        except Exception as e:
            print(f"engine dispatch exception on a {len(part)}-read chunk:"
                  f" {e}; isolating per read", file=sys.stderr)
            isolate(part)
            return
        window.append((handle, part))
        if len(window) > INFLIGHT:
            collect_safe(*window.popleft())

    for job in jobs:
        chunk.append(job)
        if len(chunk) >= CHUNK:
            submit()
    if chunk:
        submit()
    while window:
        collect_safe(*window.popleft())
    _print_profile(args, eng)


def _print_profile(args, eng) -> None:
    if not getattr(args, "profile", False):
        return
    pr = eng.profile
    n, b = max(1, pr["reads"]), max(1, pr["buckets"])
    line = (
        f"profile: {pr['reads']} reads in {pr['buckets']} buckets | "
        f"dispatch {pr['dispatch_s']:.2f}s ({pr['dispatch_s'] / b * 1e3:.0f} "
        f"ms/bucket) | device-wait+collect {pr['collect_s']:.2f}s "
        f"({pr['collect_s'] / b * 1e3:.0f} ms/bucket) | "
        f"{n / max(1e-9, pr['dispatch_s'] + pr['collect_s']):.1f} reads/s"
    )
    if "exact_retries" in pr:
        line += (f" | wide-rung retries {pr.get('wide_retries', 0)} "
                 f"({pr.get('wide_s', 0.0):.2f}s) | exact-path retries "
                 f"{pr['exact_retries']} ({pr['exact_s']:.2f}s)")
    import sys

    print(line, file=sys.stderr)


if __name__ == "__main__":
    main()
