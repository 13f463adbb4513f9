"""Where compiled XLA programs persist between processes."""

from __future__ import annotations

import os
import pathlib

#: Root of the checkout this package was imported from.
CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here; otherwise the cache lives at
    ``<checkout>/.cache/jax`` (listed in ``.gitignore``).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = CHECKOUT / ".cache" / "jax"
    jax.config.update("jax_compilation_cache_dir", str(path))
    return str(path)
