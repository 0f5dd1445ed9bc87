"""dynamont-train: mini-batch Baum-Welch parameter training.

JAX replacement for the reference CLI (ref: src/python/segmentation/
train.py). Same defaults (batch_size 24, epochs 1, qscore 10), same
checkpoint and params.csv artifacts.
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser

from dynamont_jax.constants import PORES


def build_parser() -> ArgumentParser:
    p = ArgumentParser(prog="dynamont-train")
    p.add_argument("-r", "--raw", metavar="DIR", default=None)
    p.add_argument("-b", "--basecalls", metavar="BAM", default=None)
    p.add_argument("--tsv", metavar="TSV", default=None,
                   help="Plain-TSV read source (readid, signalid, signal, read)")
    p.add_argument("-o", "--outdir", required=True)
    p.add_argument("-p", "--pore", required=True, choices=list(PORES))
    p.add_argument("--mode", choices=["basic", "resquiggle"], required=True)
    p.add_argument("--model_path", default=None,
                   help="Initial kmer model (default: packaged per-pore model)")
    p.add_argument("--batch_size", type=int, default=24)
    p.add_argument("-e", "--epochs", type=int, default=1)
    p.add_argument("-q", "--qscore", type=float, default=10.0)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--precision", choices=["auto", "fp64", "fp32"],
                   default="auto",
                   help="auto (default): fp32 where the GPU kernels run "
                        "(an H100 trains a 24-read batch about 10x faster "
                        "there than at fp64; the trained parameters stay "
                        "within the bounds PERF.md states, also for reads "
                        "whose signal ends before their bases do), the "
                        "fp64 reference-parity scan path elsewhere; fp64: "
                        "always the scan path; fp32: the kernels on a GPU, "
                        "fp32 scans elsewhere")
    p.add_argument("--resume", action="store_true",
                   help="continue from the last trained_{epoch}_{batch} "
                        "checkpoint in the output dir (skips the batches "
                        "params.csv records as done)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host run: initialize jax.distributed; every "
                        "process reads the same job stream and trains the "
                        "round-robin shard of each batch; per-read "
                        "estimates merge across processes before pooling "
                        "(identical params on every host); process 0 "
                        "writes params.csv/checkpoints (shared outdir). "
                        "Set DYNAMONT_COORDINATOR, DYNAMONT_NUM_PROCESSES, "
                        "DYNAMONT_PROCESS_ID and, for several processes on "
                        "one multi-card host, DYNAMONT_LOCAL_DEVICE (or "
                        "rely on jax.distributed's cluster autodetection).")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.tsv is None and (args.raw is None or args.basecalls is None):
        print("provide either --tsv or both --raw and --basecalls", file=sys.stderr)
        raise SystemExit(2)

    import jax

    jax.config.update("jax_enable_x64", True)
    from dynamont_jax.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.distributed:
        from dynamont_jax.parallel.mesh import init_distributed

        # fail loudly: a half-initialized "distributed" training would
        # silently train every batch on every host
        init_distributed(required=True)

    from dynamont_jax.constants import is_rna
    from dynamont_jax.io import readers
    from dynamont_jax.models.registry import get_model_path
    from dynamont_jax.training.trainer import Trainer, read_passes_filters

    rna = is_rna(args.pore)
    model_path = args.model_path or get_model_path(args.pore)
    trainer = Trainer(
        args.mode, args.pore, args.outdir, model_path,
        batch_size=args.batch_size, epochs=args.epochs, resume=args.resume,
        precision=args.precision, distributed=args.distributed,
    )

    def jobs():
        # (basecall seq, materialize thunk): batch membership only needs
        # the sequence, so skipped batches on --resume never touch raw data
        if args.tsv is not None:
            for job in readers.generate_tsv_jobs(args.tsv, rna, args.qscore):
                yield job.read_5to3, (lambda j=job: j)
        else:
            for raw in readers.generate_bam_jobs(args.raw, args.basecalls,
                                                 args.qscore):
                yield raw[5], (
                    lambda r=raw: readers.materialize_bam_job(r, rna)
                )

    try:
        for epoch in range(trainer.resume_epoch, args.epochs):
            skip = trainer.resume_skip_batches if epoch == trainer.resume_epoch else 0
            batch = []
            n_batch = 0
            for seq, make_job in jobs():
                if not read_passes_filters(seq):
                    continue
                batch.append(make_job)
                if len(batch) == args.batch_size:
                    n_batch += 1
                    if n_batch > skip:
                        materialized = []
                        for mk in batch:
                            try:
                                materialized.append(mk())
                            except Exception as e:  # unreadable raw data
                                print(f"raw read failed: {e}",
                                      file=sys.stderr)
                        if materialized:
                            trainer.process_batch(materialized, epoch)
                    batch = []
                    if args.max_batches and trainer.batch_num >= args.max_batches:
                        break
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
