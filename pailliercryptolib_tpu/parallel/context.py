"""Runtime context: device discovery, mesh setup, backend selection.

The analog of ``ipcl::initializeContext("CPU"/"QAT"/"HYBRID")``
(ipcl/utils/context.cpp:16-44): where the reference brings up the QAT
device runtime (SAL process, instance enumeration, scheduler threads), this
build initializes optional multi-process JAX, builds a 1-D device mesh
over the ciphertext batch axis, and records the preferred modexp backend
("rns" or "xla", ops/dispatch.py).  ``terminateContext`` tears the mesh
reference down.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax


@dataclasses.dataclass
class PaillierContext:
    choice: str
    mesh: Optional[jax.sharding.Mesh]
    backend: str  # "rns" | "xla"
    initialized: bool = True


_CONTEXT: Optional[PaillierContext] = None

_VALID = ("DEFAULT", "CPU", "TPU", "MESH", "HYBRID", "QAT")


def initialize_context(
    choice: str = "DEFAULT",
    *,
    distributed: bool = False,
    mesh_devices: Optional[int] = None,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> PaillierContext:
    """Bring up the runtime.

    choice:
      - "DEFAULT"/"TPU": single-process, all local devices in a 1-D mesh.
      - "CPU": force the CIOS ("xla") backend, like the reference's
        initializeContext("CPU").
      - "MESH"/"HYBRID"/"QAT": accepted for API parity with the reference's
        string map (ipcl/utils/context.cpp:16-21); "QAT"/"HYBRID" behave as
        "DEFAULT" since the accelerator here *is* the default backend.
    distributed: call jax.distributed.initialize() first (multi-host);
    coordinator_address / num_processes / process_id are forwarded (all
    required for a multi-process bring-up without a cluster environment).
    The resulting mesh then spans every device in the job, so the public
    encrypt/decrypt APIs shard batches across hosts transparently.
    """
    global _CONTEXT
    choice = choice.upper()
    if choice not in _VALID:
        raise ValueError(f"initializeContext: unknown choice {choice!r}")
    if _CONTEXT is not None and _CONTEXT.initialized:
        return _CONTEXT  # idempotent, like isUsingQAT (context.cpp:30-38)
    if distributed:
        kwargs = {}
        if coordinator_address is not None:
            kwargs["coordinator_address"] = coordinator_address
        if num_processes is not None:
            kwargs["num_processes"] = num_processes
        if process_id is not None:
            kwargs["process_id"] = process_id
        jax.distributed.initialize(**kwargs)
    devices = jax.devices()
    n = mesh_devices or len(devices)
    mesh = jax.sharding.Mesh(devices[:n], ("batch",))
    if choice == "CPU":
        backend = "xla"  # force the fallback, like initializeContext("CPU")
    else:
        from ..ops.dispatch import default_backend

        backend = default_backend()  # honors config/env overrides
    _CONTEXT = PaillierContext(choice=choice, mesh=mesh, backend=backend)
    return _CONTEXT


def get_context() -> PaillierContext:
    if _CONTEXT is None:
        return initialize_context()
    return _CONTEXT


def peek_context() -> Optional[PaillierContext]:
    """The live context if initialize_context ran, else None (engines use
    this: a context must be opted into, never auto-created)."""
    return _CONTEXT


def terminate_context() -> None:
    global _CONTEXT
    _CONTEXT = None


def is_running() -> bool:
    return _CONTEXT is not None
