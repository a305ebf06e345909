"""Persistent-compile-cache location and hygiene.

One place decides where compiled executables are cached:
``$JAX_COMPILATION_CACHE_DIR`` when it is set, otherwise the fixed
directory ``<checkout>/.jax_cache``.  The path is part of what makes a
later process find an entry again, so it is never derived from a
temporary name, a pid or the time.

JAX's on-disk compilation cache writes entries with a plain
``Path.write_bytes`` (``jax/_src/lru_cache.py``, ``LRUCache.put``),
which is NOT atomic: a process killed mid-write (a timeout, a CI kill,
ctrl-C) leaves a truncated entry on disk.  Reading such an entry later
does not fail gracefully: XLA's ``deserialize_executable`` hard-aborts
the whole process (C++ CHECK), so one interrupted run can permanently
break every later run that shares the cache directory.

``enable_persistent_cache`` turns the cache on AND makes entry writes
atomic (same-directory temp file + ``os.replace``), with a startup
sweep that removes leftover temp files and obviously-truncated
(zero-length) entries.
"""
import os
import time
import warnings

import jax

__all__ = ["cache_dir", "enable_persistent_cache", "harden_cache_writes"]

#: Cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset.
DEFAULT_CACHE_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), os.pardir, os.pardir, ".jax_cache"))


def _sweep(directory: str) -> None:
    """Remove leftover temp files / empty entries from crashed runs."""
    try:
        names = os.listdir(directory)
    except OSError:
        return
    for name in names:
        path = os.path.join(directory, name)
        try:
            if ".__tmp." in name or os.path.getsize(path) == 0:
                os.unlink(path)
        except OSError:
            pass  # racing process already cleaned it


def harden_cache_writes() -> None:
    """Make ``LRUCache.put`` atomic (idempotent, safe to call twice)."""
    from jax._src import lru_cache as _lru

    if getattr(_lru.LRUCache.put, "_atomic_writes", False):
        return

    suffix = _lru._CACHE_SUFFIX
    atime_suffix = _lru._ATIME_SUFFIX

    def atomic_put(self, key, val):
        # Mirrors the upstream body (jax 0.9, lru_cache.py:121-161)
        # with the single write replaced by temp-file + rename, which
        # is atomic within one directory on POSIX.
        if not key:
            raise ValueError("key cannot be empty")
        if self.eviction_enabled and len(val) > self.max_size:
            warnings.warn(
                f"Cache value for key {key!r} of size {len(val)} bytes "
                f"exceeds the maximum cache size of {self.max_size} "
                f"bytes")
            return
        cache_path = self.path / f"{key}{suffix}"
        if self.eviction_enabled:
            self.lock.acquire(timeout=self.lock_timeout_secs)
        try:
            if cache_path.exists():
                return
            if self.eviction_enabled:
                self._evict_if_needed(additional_size=len(val))
            tmp_path = self.path / f"{key}{suffix}.__tmp.{os.getpid()}"
            try:
                tmp_path.write_bytes(val)
                os.replace(tmp_path, cache_path)
            except OSError:
                try:
                    tmp_path.unlink()
                except OSError:
                    pass
                return  # a failed cache write must never fail the run
            if self.eviction_enabled:
                timestamp = time.time_ns().to_bytes(8, "little")
                atime_path = self.path / f"{key}{atime_suffix}"
                atime_path.write_bytes(timestamp)
        finally:
            if self.eviction_enabled:
                self.lock.release()

    atomic_put._atomic_writes = True
    _lru.LRUCache.put = atomic_put


def cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else
    ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_persistent_cache(min_compile_time_secs: float = 0.2) -> str:
    """Enable the hardened on-disk compile cache at :func:`cache_dir`
    and return that directory."""
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    _sweep(path)
    harden_cache_writes()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    return path
