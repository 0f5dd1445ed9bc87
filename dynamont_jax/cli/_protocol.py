"""Shared stdin/stdout protocol for the single-read CLIs.

Contract (ref: NT_main.cpp:77-123, README.md:106-122):
  stdin line 1: comma-separated signal values
  stdin line 2: read (processing orientation)
  exit codes: 3 Z mismatch, 4 signal missing, 5 read missing, 6 model kmer
  length mismatch, 7 bad model path, 8-11 input size violations.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def force_x64() -> None:
    """Single-read CLIs run the exact-parity f64 path."""
    import jax

    from dynamont_jax.compile_cache import enable_compile_cache

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    if os.environ.get("DYNAMONT_FORCE_CPU", "0") == "1":
        jax.config.update("jax_platforms", "cpu")


def read_stdin_pair() -> tuple[np.ndarray, str]:
    signal_line = sys.stdin.readline().strip()
    read_line = sys.stdin.readline().strip()
    if not signal_line:
        print("Signal missing!", file=sys.stderr)
        raise SystemExit(4)
    if not read_line:
        print("Read missing!", file=sys.stderr)
        raise SystemExit(5)
    signal = np.array([float(x) for x in signal_line.split(",")], dtype=np.float64)
    return signal, read_line


def check_model_path(path: str) -> None:
    if not path or not os.path.exists(path):
        print(f"Please provide a valid modelpath: {path}", file=sys.stderr)
        raise SystemExit(7)


def load_model_or_exit(path: str, rna: bool):
    from dynamont_jax.utils.pore_model import load_pore_model

    check_model_path(path)
    try:
        return load_pore_model(path, rna)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        raise SystemExit(6)


def fmt(v: float) -> str:
    """std::fixed << setprecision(11) equivalent."""
    return f"{v:.11f}"


def print_train_output(trained_transitions: dict, trained_emissions: dict, Z: float) -> None:
    print(";".join(f"{k}:{fmt(v)}" for k, v in trained_transitions.items()))
    print("".join(f"{kmer}:{fmt(m)},{fmt(s)};" for kmer, (m, s) in trained_emissions.items()))
    print(f"Z:{fmt(Z)}")
