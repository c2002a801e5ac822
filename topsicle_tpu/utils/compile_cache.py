"""Persistent XLA compilation cache.

The reference tool has no compile step; here every CLI process compiles
a dozen device programs before its first batch.  JAX's persistent
compilation cache lets every run after the first load them instead,
which matters for a CLI tool invoked per input batch/job (the
reference's usage model, README.md:261-270, splits work into many short
jobs).

The cache lives where JAX_COMPILATION_CACHE_DIR says, when that is set;
otherwise at `<repo root>/.jax_cache`, a fixed path (the path is part of
the cache key, so a directory that moves between runs never hits).
"""

from __future__ import annotations

import contextlib
import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")

# fired once per XLA compile request, whether it compiles or loads the
# program from the persistent cache (jax._src.dispatch)
_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> str | None:
    """Turn on JAX's persistent compilation cache at cache_dir() and
    return that directory, or None when it cannot be created (read-only
    checkout)."""
    import jax

    target = cache_dir()
    try:
        os.makedirs(target, exist_ok=True)
    except OSError:
        return None
    jax.config.update("jax_compilation_cache_dir", target)
    # cache every program, even fast-compiling ones: each CLI process
    # starts cold, and a dozen small compiles add up per run
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return target


@contextlib.contextmanager
def count_compiled_programs():
    """Collect the names of the device programs compiled (or loaded from
    the persistent cache) inside the block; yields the list."""
    import jax

    names: list = []

    def listener(event, duration_secs, **kwargs):
        if event == _COMPILE_EVENT:
            names.append(kwargs.get("fun_name"))

    jax.monitoring.register_event_duration_secs_listener(listener)
    try:
        yield names
    finally:
        jax.monitoring.unregister_event_duration_listener(listener)
