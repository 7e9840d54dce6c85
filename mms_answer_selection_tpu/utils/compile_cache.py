"""Persistent XLA compilation cache.

The reference pays its graph-construction cost per process (Net::Init,
net.cpp:40-275); the analogous cost here is XLA compilation, which for the
fused K-step training scan takes minutes.  JAX's persistent cache makes it
a one-time cost across processes.

Where the cache lives: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads
it itself and this module sets no directory.  Otherwise the cache goes to
``<checkout>/.jax_cache`` -- a fixed path, because the path is part of the
cache key and a directory that moves never hits.  ``.gitignore`` lists it.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger("mms.cache")

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache(min_compile_secs: float = 2.0) -> str | None:
    """Turn on JAX's on-disk compilation cache (idempotent, safe to call
    before or after backend init -- it only affects future compiles).

    Returns the directory in use: ``$JAX_COMPILATION_CACHE_DIR`` when set,
    else DEFAULT_DIR; None if enabling failed (read-only filesystem, ...)
    -- callers never need to handle that."""
    import jax

    try:
        path = os.environ.get(ENV_VAR)
        if not path:
            path = DEFAULT_DIR
            os.makedirs(path, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          float(min_compile_secs))
        return path
    except Exception as e:  # noqa: BLE001 -- never fail the caller
        log.debug("compilation cache unavailable: %s", e)
        return None
