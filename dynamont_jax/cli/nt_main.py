"""dynamont-NT: full-lattice 2-state segmentation of one read from stdin.

JAX replacement for the reference binary of the same name
(ref: src/cpp/NT_main.cpp). Same flags, same stdin/stdout protocol,
same exit codes.
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser


def build_parser() -> ArgumentParser:
    p = ArgumentParser(prog="dynamont-NT", description="dynamont basic")
    p.add_argument("-m", "--model", required=True, dest="model")
    p.add_argument(
        "-r", "--pore", required=True, dest="pore",
        choices=["rna002", "dna_r9", "rna004", "dna_r10_260bps", "dna_r10_400bps"],
    )
    p.add_argument("-m1", "--matchscore1", type=float, default=-1.0, dest="m1")
    p.add_argument("-e1", "--extendscore1", type=float, default=-1.0, dest="e1")
    p.add_argument("-e2", "--extendscore2", type=float, default=-1.0, dest="e2")
    p.add_argument("--train", action="store_true")
    p.add_argument("-z", "--calcZ", action="store_true", dest="calcZ")
    p.add_argument("-p", "--probabilty", action="store_true", dest="prob")
    p.add_argument("-t", type=int, default=1, dest="threads")  # accepted, unused
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from dynamont_jax.cli._protocol import (
        fmt,
        force_x64,
        load_model_or_exit,
        print_train_output,
        read_stdin_pair,
    )
    from dynamont_jax.constants import is_rna

    force_x64()
    rna = is_rna(args.pore)
    model = load_model_or_exit(args.model, rna)
    signal, read = read_stdin_pair()

    from dynamont_jax.models.nt import ZConsistencyError, run_nt
    from dynamont_jax.utils.output import segments_to_string

    overrides = {"m1": args.m1, "e1": args.e1, "e2": args.e2}
    mode = "calcZ" if args.calcZ else ("train" if args.train else "segment")
    try:
        res = run_nt(signal, read, model, args.pore, overrides, mode=mode, want_prob=args.prob)
    except ZConsistencyError as e:
        print(str(e), file=sys.stderr)
        raise SystemExit(3)

    if mode == "calcZ":
        print(fmt(res.Z))
    elif mode == "train":
        print_train_output(res.trained_transitions, res.trained_emissions, res.Z)
    else:
        print(segments_to_string(res.segments))
        if args.prob:
            print("".join(fmt(v) + "," for v in res.per_t_logprob))


if __name__ == "__main__":
    main()
