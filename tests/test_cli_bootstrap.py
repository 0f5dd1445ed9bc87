"""CLI bootstrap behaviors.

- enable_compile_cache: every CLI process enables the one persistent XLA
  compile cache (JAX_COMPILATION_CACHE_DIR, else .jax_cache/ in the
  checkout).
- engine batch-size defaults: basic mode 256 (one GPU program per read:
  a 256-read bucket fills the H100's SMs, PERF.md), resquiggle 16.
"""

import os

import jax
import pytest

from dynamont_jax import compile_cache
from dynamont_jax.cli import resquiggle as cli_resq


def test_enable_compile_cache_sets_config(tmp_path, monkeypatch):
    monkeypatch.delenv("DYNAMONT_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    old = jax.config.jax_compilation_cache_dir
    try:
        compile_cache.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")
        assert os.path.isdir(str(tmp_path / "cc"))
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_enable_compile_cache_opt_out(monkeypatch):
    monkeypatch.setenv("DYNAMONT_NO_COMPILE_CACHE", "1")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent/nope")
    old = jax.config.jax_compilation_cache_dir
    try:
        compile_cache.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == old
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_enable_compile_cache_default_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("DYNAMONT_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    try:
        compile_cache.enable_compile_cache()
        # a fixed path at the checkout root, never under HOME
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        want = os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("mode,flag,expect", [
    ("basic", None, 256),
    ("basic", 8, 8),
    ("resquiggle", None, 16),
    ("resquiggle", 48, 48),
])
def test_engine_batch_size_defaults(monkeypatch, tmp_path, mode, flag,
                                    expect):
    """The pump never runs (stubbed); only the engine construction args
    are checked."""
    seen = {}

    class FakeEngine:
        def __init__(self, *a, **kw):
            seen.update(kw)

    import dynamont_jax.models.batch as mb
    import dynamont_jax.models.ntc_batch as mnb

    monkeypatch.setattr(mb, "BandedBatchEngine", FakeEngine)
    monkeypatch.setattr(mnb, "NTCBatchEngine", FakeEngine)
    monkeypatch.setattr(cli_resq, "_pump_engine",
                        lambda *a, **kw: None)
    tsv = tmp_path / "r.tsv"
    tsv.write_text("")  # no reads; the pump is stubbed anyway
    args = ["--tsv", str(tsv), "-o", str(tmp_path / "o.csv.zst"),
            "--mode", mode, "-p", "rna002"]
    if flag is not None:
        args += ["--batch_size", str(flag)]
    cli_resq.main(args)
    assert seen.get("batch_size") == expect
