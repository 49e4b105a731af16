"""Persistent XLA compilation cache wiring.

The reference binary starts computing instantly (main.cpp has no compile
step); a JAX process pays seconds to minutes of XLA compilation per distinct
program shape on its first run. The persistent compilation cache removes
that cost for every later process. This helper is called from
Problem.__init__ so EVERY entry point (api.Quandary, the CLI, the device
driver, user scripts) shares one on-disk cache.

Where the cache lives:
    JAX_COMPILATION_CACHE_DIR set  -> JAX reads it into
        jax_compilation_cache_dir at start-up; it is kept as it is.
    otherwise                      -> `.jax_cache` at the root of the
        checkout (listed in .gitignore): a fixed path, because the path is
        part of the cache key.
    QTPU_NO_XLA_CACHE=1            -> leave whatever the process configured.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")

_wired = False


def enable_persistent_cache() -> None:
    """Idempotently point JAX's compilation cache at a durable directory,
    unless the process (or JAX_COMPILATION_CACHE_DIR) already chose one."""
    global _wired
    if _wired or os.environ.get("QTPU_NO_XLA_CACHE"):
        return
    _wired = True
    import jax

    if jax.config.jax_compilation_cache_dir:
        return
    try:
        os.makedirs(CACHE_DIR, exist_ok=True)
    except OSError:
        return
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    # cache small, fast-compiling entries too: the flagship programs are
    # small, and a cold process pays their compile every time otherwise
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
