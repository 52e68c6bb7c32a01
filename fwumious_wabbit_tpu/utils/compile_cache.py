"""Persistent XLA compilation-cache setup (shared by the CLI and bench).

Rules, in order:

1. ``--fwt_compile_cache off`` disables the cache.
2. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
   this module sets no other directory.
3. ``--fwt_compile_cache DIR`` places the cache in DIR.
4. A run pinned to the CPU (``--fwt_platform cpu`` or a ``JAX_PLATFORMS``
   whose first entry is ``cpu``, as in the tests) keeps no cache.
5. Otherwise the cache lives at :data:`DEFAULT_DIR`, a fixed path inside
   the checkout: the path is part of what makes a later process find the
   entries, so it must not follow the working directory.

Every compile is cached (no minimum compile time), so a second process
over the same configuration compiles nothing: it also keeps one autotuned
choice per program. jax is imported only when the cache engages — the
embedded-engine predict path calls this only once it uses the device.
"""

from __future__ import annotations

import os
from pathlib import Path

from .logging import get_logger

log = get_logger(__name__)

DEFAULT_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")


def _pinned_to_cpu(args) -> bool:
    platform = getattr(args, "fwt_platform", None) if args else None
    if platform is None:
        platform = os.environ.get("JAX_PLATFORMS") or ""
    # a priority list ("cuda,cpu") is judged by its first entry: cpu there
    # is only the fallback
    plats = [p.strip() for p in str(platform).split(",") if p.strip()]
    return bool(plats) and plats[0] == "cpu"


def compile_cache_dir(args=None) -> str | None:
    """The directory the rules above choose, or None when the cache is off.
    A directory from ``JAX_COMPILATION_CACHE_DIR`` is returned as is."""
    flag = getattr(args, "fwt_compile_cache", None) if args else None
    if flag == "off":
        return None
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if flag is not None:
        return flag
    if _pinned_to_cpu(args):
        return None
    return DEFAULT_DIR


def configure_compile_cache(args=None) -> str | None:
    """Apply :func:`compile_cache_dir` to JAX's config before the first
    compile; returns the directory in use (None: off)."""
    cache_dir = compile_cache_dir(args)
    if cache_dir is None:
        if os.environ.get("JAX_COMPILATION_CACHE_DIR"):  # 'off' beats it
            import jax

            jax.config.update("jax_enable_compilation_cache", False)
        return None
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            os.makedirs(cache_dir, exist_ok=True)
        except OSError as e:
            log.warning("compilation cache disabled: %s", e)
            return None
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return cache_dir
