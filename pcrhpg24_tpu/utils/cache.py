"""The persistent XLA compilation cache: one place decides where it lives.

JAX_COMPILATION_CACHE_DIR, when set, is used as it is (JAX reads it
itself).  Otherwise the cache goes to `<repo>/.jax_cache`, a fixed path
inside the checkout (the path is part of the cache key, so a moving
directory never hits).
"""

import os

import jax

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
