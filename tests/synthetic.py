"""Shim: synthetic read generator now lives in the package (used by bench)."""

from dynamont_jax.utils.synthetic import BASES, make_read, signal_to_text  # noqa: F401
