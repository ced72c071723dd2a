"""Device stamp for measurement output: what ran, on which card.

Every benchmark line names its device (JAX's platform, device kind and
count) and, on a GPU, the card's name and power limit as nvidia-smi
reports them — read by a child process that never touches JAX.  A
measurement that finds no GPU stops instead of timing the CPU.
"""

from __future__ import annotations

import subprocess


def card_info() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def device_stamp(allow_cpu: bool = False) -> dict:
    """{platform, device_kind, device_count, card}; raises SystemExit when
    JAX finds no GPU (unless ``allow_cpu``, for harness smoke runs)."""
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu" and not allow_cpu:
        raise SystemExit(f"needs a GPU; JAX found platform {d.platform!r}")
    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": len(devs),
        "card": card_info() if d.platform == "gpu" else None,
    }
