"""JAX's persistent compilation cache at a fixed place.

A cold run compiles every engine drive, which on a GPU can take longer than
the run itself. The persistent cache keeps the executables between
processes. Its key includes the cache path, so the path must not move from
one run to the next.

``enable_compile_cache()`` is called once, before the first compilation,
by the entry points that open the device (``chip_smoke.py``, ``bench.py``,
``python -m fugue_tpu.serve``).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

# <checkout>/.jax_cache — listed in .gitignore
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here. Otherwise the cache goes to ``DEFAULT_DIR``."""
    import jax

    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
