"""Where JAX keeps its persistent compile cache for this program.

JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and wins:
nothing else is set in code.  Otherwise the cache lives at
<checkout>/.jax_cache, one fixed path.  Call enable() before the first
compile of a process; JAX opens the cache once, at that compile.

The Pallas-Triton MTF kernel reaches XLA as serialized Triton IR that
carries source locations, and that IR is part of the cache key.  By
default a location is the whole Python stack of the trace, with full
paths, so the key would change with the checkout's path and with the
caller.  enable() makes each location one frame, named without its
directory (KEY_SETTINGS), unless the environment sets those options.
"""

from __future__ import annotations

import os
import pathlib

CHECKOUT_CACHE = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"
KEY_SETTINGS = {
    "jax_hlo_source_file_canonicalization_regex": ".*/",
    "jax_include_full_tracebacks_in_locations": False,
}


def enable() -> str:
    """Point JAX at the cache directory and return it."""
    import jax
    for name, value in KEY_SETTINGS.items():
        if name.upper() not in os.environ:
            jax.config.update(name, value)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT_CACHE)
    if jax.config.jax_compilation_cache_dir != path:
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def enable_for_device() -> str | None:
    """enable(), unless JAX runs on the CPU: CPU runs (the tests) keep
    no persistent cache in the checkout."""
    import jax
    return None if jax.default_backend() == "cpu" else enable()
