"""dynamont-NT-banded: banded 2-state segmentation of one read from stdin
(ref: src/cpp/NT_banded_main.cpp — same flags plus -b/--band, same protocol)."""

from __future__ import annotations

import sys

from dynamont_jax.cli.nt_main import build_parser


def main(argv=None) -> None:
    p = build_parser()
    p.prog = "dynamont-NT-banded"
    p.add_argument("-b", "--band", type=int, default=400, dest="band")
    args = p.parse_args(argv)

    from dynamont_jax.cli._protocol import (
        fmt,
        force_x64,
        load_model_or_exit,
        print_train_output,
        read_stdin_pair,
    )
    from dynamont_jax.constants import is_rna

    force_x64()
    model = load_model_or_exit(args.model, is_rna(args.pore))
    signal, read = read_stdin_pair()

    from dynamont_jax.models.nt import ZConsistencyError
    from dynamont_jax.models.nt_banded import run_nt_banded
    from dynamont_jax.utils.output import segments_to_string

    overrides = {"m1": args.m1, "e1": args.e1, "e2": args.e2}
    mode = "calcZ" if args.calcZ else ("train" if args.train else "segment")
    try:
        res = run_nt_banded(
            signal, read, model, args.pore, overrides, mode=mode,
            want_prob=args.prob, band=args.band,
        )
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
