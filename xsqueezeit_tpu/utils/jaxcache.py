"""Persistent XLA compilation cache.

The codec compiles a small closed set of bucketed shapes per panel width;
keeping the compiled executables on disk lets every run after the first
skip the compile.  Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already
caches there and nothing is set in code; otherwise the cache lives at a
fixed `.jax_cache/` in the checkout root (listed in .gitignore), so its
path — part of the cache key — stays the same from run to run.  Called by
the device codec modules (encoder_jax / decoder_jax / parallel.shard)
before their first jit dispatch.
"""
from __future__ import annotations

import os

#: `<checkout>/.jax_cache`, the cache used when JAX_COMPILATION_CACHE_DIR
#: is unset.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

_done = False


def cache_dir() -> str:
    """The directory the compile cache lands in."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def ensure_compilation_cache() -> None:
    global _done
    if _done:
        return
    _done = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
