"""Process-level JAX set-up shared by the CLI and the benchmark scripts."""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def enable_compile_cache() -> str:
    """Keep XLA's compiled programs on disk across processes.

    Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and
    this sets nothing.  Otherwise the cache goes to `<checkout>/.jax_cache`
    (a fixed path: the path is part of the cache key).  Returns the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env is not None:
        return env
    import jax

    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_facts() -> dict:
    """The devices JAX runs on, as it reports them."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
    }
