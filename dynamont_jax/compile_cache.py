"""The program's one persistent XLA compile cache.

`JAX_COMPILATION_CACHE_DIR` names the directory when it is set; otherwise
the cache is `.jax_cache/` at the root of the checkout (listed in
.gitignore), a fixed path, so every process of the checkout (CLIs, tests,
bench.py, chip_smoke.py) finds what the others compiled.
DYNAMONT_NO_COMPILE_CACHE=1 turns it off.
"""

from __future__ import annotations

import os
import sys

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> None:
    """Point jax at the cache directory; call before the first compile."""
    import jax

    if os.environ.get("DYNAMONT_NO_COMPILE_CACHE") == "1":
        return
    path = cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception as e:  # unwritable cache dir: run uncached
        print(f"compile cache disabled ({e})", file=sys.stderr)
