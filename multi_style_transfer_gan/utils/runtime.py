"""Runtime utilities: persistent compilation cache and simple profiling.

Every CLI/pipeline entry point calls ``enable_compilation_cache`` so
recompiles across processes are disk-cache hits. Observability
(SURVEY.md §5.1/§5.5): the reference only prints wall-clock and per-image
seconds (batch_process_images.py:495-536); ``throughput_meter`` reproduces
that and adds a ``jax.profiler`` hook.
"""

from __future__ import annotations

import os
import time

import jax

# <repo>/.jax_cache (listed in .gitignore). A fixed path: the path is part
# of the cache key, so a directory that moves never hits.
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compilation_cache_dir() -> str:
    """Where the persistent compilation cache lives:
    ``JAX_COMPILATION_CACHE_DIR`` when it is set, else <repo>/.jax_cache.
    JAX's cache key already covers the backend and its version."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compilation_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compilation cache (idempotent). Where
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    other directory is set here. Returns the directory in use."""
    path = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


class throughput_meter:
    """Context manager printing imgs/sec + per-image seconds like the
    reference's batch report, with optional jax.profiler trace capture."""

    def __init__(self, n_items: int, label: str = "processed",
                 trace_dir: str | None = None):
        self.n = n_items
        self.label = label
        self.trace_dir = trace_dir

    def __enter__(self):
        if self.trace_dir:
            jax.profiler.start_trace(self.trace_dir)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        if self.trace_dir:
            jax.profiler.stop_trace()
        per = self.elapsed / max(self.n, 1)
        print(f"{self.label}: {self.n} items in {self.elapsed:.2f}s "
              f"({self.n / max(self.elapsed, 1e-9):.2f}/s, {per:.3f}s each)")
        return False


class MetricsLogger:
    """Append-only JSONL metrics log for the training CLIs
    (SURVEY.md §5.5 — the reference's only observability is stdout prints).
    No-op when constructed with ``path=None``."""

    def __init__(self, path=None):
        self.path = path
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                        exist_ok=True)
            self._f = open(path, "a", buffering=1)

    def log(self, **record):
        if self._f is None:
            return
        import json

        record.setdefault("t", time.time())
        self._f.write(json.dumps(record) + "\n")

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
