"""Runtime configuration: one dataclass + environment overrides.

The reference's three config tiers (CMake options -> compile definitions,
env vars like IPCL_DISABLE_AVX512IFMA / IPCL_NUM_THREADS, and runtime API
calls; SURVEY.md §5 "Config / flag system") collapse here into a single
dataclass whose defaults can be overridden by environment variables, plus
the runtime API in ops/dispatch.py (hybrid mode) and parallel/context.py.

Env overrides (checked once at first access):
  PAILLIER_TPU_BACKEND       "rns" | "xla" (ops/dispatch.py)
  PAILLIER_TPU_BATCH_TILE    batch padding unit (informational; engines pin 128)
  PAILLIER_TPU_WINDOW_BITS   exponent window width (informational; 4)
  PAILLIER_TPU_PERF          "1" -> print per-batch device timings
  JAX_COMPILATION_CACHE_DIR  persistent compile cache location (default:
                             <checkout>/.jax_cache, see compile_cache_dir)
"""

from __future__ import annotations

import dataclasses
import os
import time
from contextlib import contextmanager
from typing import Optional


@dataclasses.dataclass
class Config:
    backend: Optional[str] = None  # None -> auto (ops/dispatch.default_backend)
    batch_tile: int = 128
    window_bits: int = 4
    limb_bits: int = 15
    rns_mod_bits: int = 14
    perf: bool = False

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            backend=os.environ.get("PAILLIER_TPU_BACKEND"),
            perf=os.environ.get("PAILLIER_TPU_PERF", "0") == "1",
        )


_CONFIG: Optional[Config] = None


def compile_cache_dir() -> str:
    """The persistent compile cache directory: JAX_COMPILATION_CACHE_DIR
    when set, else the fixed path <checkout>/.jax_cache (derived from this
    package's location, so every process of one checkout shares it)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`
    (the one place in this repository that sets it); returns the path."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def get_config() -> Config:
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = Config.from_env()
        enable_compile_cache()
    return _CONFIG


def set_config(cfg: Config) -> None:
    global _CONFIG
    _CONFIG = cfg


# ---------------------------------------------------------------------------
# perf counters (the HE_QAT_PERF analog, heqat ctrl.c:497-499 / cb.c:62)
# ---------------------------------------------------------------------------


@contextmanager
def perf_timer(label: str):
    """Wall-clock a batched operation and print when perf mode is on."""
    t0 = time.perf_counter()
    yield
    if get_config().perf:
        dt = (time.perf_counter() - t0) * 1000.0
        print(f"[paillier-tpu perf] {label}: {dt:.2f} ms", flush=True)
