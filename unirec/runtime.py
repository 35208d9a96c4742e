"""Process set-up shared by the entry points (``python -m unirec``,
``bench.py``, ``chip_smoke.py``).

JAX's persistent compilation cache: where ``JAX_COMPILATION_CACHE_DIR`` is
set, JAX reads it itself and nothing is set here; otherwise the cache goes
to ``<repo>/.jax_cache``, a fixed path, so that later processes find what
earlier ones compiled.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def setup_runtime() -> str:
    """Points the compile cache at its directory and returns that path."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
