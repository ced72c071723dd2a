"""Backend choice for the batched modexp primitive.

The analog of the reference's single dispatch seam ``ipcl::modExp``
(ipcl/mod_exp.cpp:680-737), which routes between the QAT offload runtime and
the AVX512 multi-buffer CPU path with a tunable hybrid ratio.  Here the
backends are:

* ``"rns"`` — RNS Montgomery arithmetic with digit-plane matmuls
  (ops/rns.py; the default on every platform)
* ``"xla"`` — the limb-serial CIOS implementation (ops/montgomery.py): the
  hybrid-split secondary, and the fallback for moduli wider than the RNS
  prime pool serves

plus the IPCL-compatible hybrid-mode knobs (``set_hybrid_mode`` /
``set_hybrid_ratio`` / ``set_hybrid_off``, mod_exp.hpp:16-48): a fractional
split of the batch between the two backends, preserved as an API/policy
seam even though a single backend is the default policy.
"""

from __future__ import annotations

import enum
import threading

BACKENDS = ("rns", "xla")


class HybridMode(enum.IntEnum):
    """Mirrors ipcl::HybridMode (mod_exp.hpp:15-29) value-for-value; a
    member's value is the percent of the batch routed to the *primary*
    backend (RNS — the reference's QAT analog); the rest runs on the CIOS
    fallback (the reference's IPP analog)."""

    OPTIMAL = 95  # per-op tuned ratios, workload-size gated
    FULL = 100  # reference "QAT": everything on the primary backend
    PREF_KERNEL90 = 90
    PREF_KERNEL80 = 80
    PREF_KERNEL70 = 70
    PREF_KERNEL60 = 60
    HALF = 50
    PREF_XLA60 = 40
    PREF_XLA70 = 30
    PREF_XLA80 = 20
    PREF_XLA90 = 10
    XLA = 0  # reference "IPP": everything on the pure-XLA fallback
    UNDEFINED = -1  # manual ratio in force (set_hybrid_ratio)


#: Workload size above which OPTIMAL mode applies the per-op ratio
#: (ipcl/utils/common.hpp:18: IPCL_WORKLOAD_SIZE_THRESHOLD).
WORKLOAD_SIZE_THRESHOLD = 128

#: Per-op OPTIMAL ratios: fraction of the batch on the primary backend.
#: The reference's QAT-tuned values are encrypt 0.25 / decrypt 0.12 /
#: multiply 0.18 (ipcl/utils/common.hpp:20-23) because its accelerator
#: loses to AVX512 on most of the batch.  Here 1.0 (no split) is policy:
#: the split has not been measured on the H100
#: (benchmarks/bench_hybrid.py sweeps it).
OPTIMAL_RATIOS = {"encrypt": 1.0, "decrypt": 1.0, "multiply": 1.0}
HYBRID_RATIO_FULL = 1.0


class _HybridParams(threading.local):
    def __init__(self):
        self.mode: HybridMode = HybridMode.OPTIMAL
        self.ratio: float = 1.0


_params = _HybridParams()


def set_hybrid_mode(mode: HybridMode) -> None:
    _params.mode = mode
    _params.ratio = max(int(mode), 0) / 100.0


def set_hybrid_ratio(ratio: float, reset_mode: bool = True) -> None:
    """Route ``ratio`` of every batch to the primary backend (the
    reference's setHybridRatio, mod_exp.cpp:35-42)."""
    if not 0.0 <= ratio <= 1.0:
        raise ValueError("hybrid ratio must be in [0, 1]")
    _params.ratio = ratio
    if reset_mode:
        _params.mode = HybridMode.UNDEFINED


def set_hybrid_off() -> None:
    """Back to the single-backend default (OPTIMAL policy).  The reference's
    setHybridOff disables its accelerator (ratio 0); here the accelerator IS
    the platform, so "off" means "no manual split"."""
    _params.mode = HybridMode.OPTIMAL
    _params.ratio = 1.0


def get_hybrid_ratio() -> float:
    return _params.ratio


def get_hybrid_mode() -> HybridMode:
    return _params.mode


def is_hybrid_optimal() -> bool:
    return _params.mode == HybridMode.OPTIMAL


def hybrid_head_count(op: str, size: int, backend: str) -> int:
    """Rows of a ``size``-row batch to run on the primary (RNS) backend;
    the rest goes to the CIOS fallback pipeline.

    The reference's split point (ipcl/mod_exp.cpp:688-732) with its per-op
    OPTIMAL policy (isHybridOptimal branches at pub_key.cpp:119-125,
    pri_key.cpp:76-82, ciphertext.cpp:153-159).  Truncation matches the
    reference's static_cast<size_t>(ratio * size).
    """
    if backend == "xla":
        return size  # the primary IS the fallback: nothing to split
    if _params.mode == HybridMode.OPTIMAL:
        ratio = (
            OPTIMAL_RATIOS.get(op, HYBRID_RATIO_FULL)
            if size > WORKLOAD_SIZE_THRESHOLD
            else HYBRID_RATIO_FULL
        )
    else:
        ratio = _params.ratio
    return size if ratio >= 1.0 else int(ratio * size)


def default_backend() -> str:
    """Pick the modexp backend for this process: the runtime config
    (utils/config.set_config, or the PAILLIER_TPU_BACKEND env var it
    loads) when it pins one, else ``"rns"`` on every platform — the
    analog of the reference's IPCL_DISABLE_AVX512IFMA-style runtime
    overrides (ipcl/include/ipcl/utils/util.hpp:48-64)."""
    import os

    from ..utils.config import get_config

    # Config snapshots the environment once at first access; re-read the
    # env var when no backend is pinned so late os.environ mutation
    # (common in tests) still takes effect per call.
    forced = get_config().backend or os.environ.get("PAILLIER_TPU_BACKEND")
    return check_backend(forced) if forced else "rns"


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown modexp backend {backend!r}; expected one of {BACKENDS}"
        )
    return backend
