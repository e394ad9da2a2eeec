"""Where the persistent XLA compilation cache lives.

One rule for every entry point (the CLI, ``bench.py``, ``chip_smoke.py``):
``JAX_COMPILATION_CACHE_DIR`` wins when it is set — JAX reads it itself and
nothing is set in code — otherwise the cache sits at the fixed path
``<repo>/.jax_cache``.  A fixed path matters: the directory is part of
what a later process must find again, so it never carries a pid, a time
or a temporary name.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable() -> str:
    """Turn the persistent cache on (before the first compile) and return
    its directory."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    return str(REPO_CACHE)
