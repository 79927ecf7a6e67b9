"""Persistent compilation cache setup.

JAX keeps every compiled program that took longer than half a second in
an on-disk cache, so a later process with the same programs, shapes and
device skips the compile. Where ``JAX_COMPILATION_CACHE_DIR`` is set,
JAX reads it itself and this module sets no other directory; otherwise
the cache lives at a fixed path inside the checkout (``<repo>/.jax_cache``,
listed in .gitignore), because the path is part of what makes a later
run find its entries. Called by the CLIs, bench.py and __graft_entry__
before any jit executes.
"""
from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> None:
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
