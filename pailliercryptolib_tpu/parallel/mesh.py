"""Multi-chip execution: shard_map over a device mesh.

The reference has **no** distributed backend (SURVEY.md §2.5) — its only
"remote" resource is the PCIe QAT co-processor.  This module creates what a
multi-device build needs instead: the ciphertext batch axis sharded across
devices (pure data parallelism — batched modexp is embarrassingly parallel,
so the only communication is input/output distribution), plus a second
mesh axis for the CRT residue systems (decrypt's p^2/q^2 halves can run on
disjoint device groups, the multi-device generalization of the reference's
2-way CRT decomposition, ipcl/pri_key.cpp:114-146).

The mesh follows the algorithm alone (a 1-D batch axis); devices joined
all to all need no topology-shaped layout.  The stages are wrapped in
``jax.shard_map``: every device runs the whole pipeline on its local batch
shard, so no collectives appear in the steady state.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import paillier_ops as pops


def make_mesh(
    n_devices: Optional[int] = None, *, crt_axis: bool = False
) -> Mesh:
    """1-D {'batch'} mesh, or 2-D {'crt': 2, 'batch': n/2} when crt_axis."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if crt_axis:
        if n % 2:
            raise ValueError("crt_axis mesh needs an even device count")
        devs = np.asarray(devices[:n]).reshape(2, n // 2)
        return Mesh(devs, ("crt", "batch"))
    return Mesh(np.asarray(devices[:n]), ("batch",))


def _replicated(mesh: Mesh):
    return P(*(None for _ in mesh.axis_names))


def sharded_encrypt_djn(mesh: Mesh):
    """shard_map'd CIOS DJN encrypt: batch axis split across 'batch'
    devices."""
    op = pops.encrypt_djn_op
    data = P("batch", None)  # [B, L] arrays split on batch
    const = P(None)  # [L] arrays replicated
    fn = jax.shard_map(
        op,
        mesh=mesh,
        in_specs=(data, data, const, const, P(), const, const, const),
        out_specs=data,
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_decrypt_crt(mesh: Mesh):
    """shard_map'd CIOS CRT decrypt over a {'crt', 'batch'} or {'batch'}
    mesh.

    On a 2-D mesh the [2, ...] residue-system arrays are additionally split
    on the 'crt' axis, so each half-width modexp batch runs on its own
    device group — the scaled-out version of the reference's two
    ``modExp`` calls at ipcl/pri_key.cpp:133-134.
    """
    two_d = "crt" in mesh.axis_names

    if not two_d:
        op = pops.decrypt_crt_op
        data = P("batch", None)
        g_const = P(None, None)
        g_wins = P(None, None, None)
        const = P(None)
        fn = jax.shard_map(
            op,
            mesh=mesh,
            in_specs=(
                data,  # ct [B, 2*Lp2]
                g_const, P(None), g_const, g_const,  # sq_n, sq_n0inv, sq_r2, sq_one
                g_wins,  # exp_wins [2, 1, NW]
                g_const, g_const,  # hensel, hfun
                g_const, P(None), g_const,  # pq_n, pq_n0inv, pq_r2
                const, const,  # pinv_q, p_limbs
            ),
            out_specs=data,
            check_vma=False,
        )
        return jax.jit(fn)

    # 2-D mesh: split the heavy grouped modexp on ('crt', 'batch'), run the
    # recombination data-parallel on a flattened view of the mesh.
    data = P(("crt", "batch"), None)  # batch split over ALL devices
    g_const = P(None, None)
    fn = jax.shard_map(
        pops.decrypt_crt_op,
        mesh=mesh,
        in_specs=(
            data,
            g_const, P(None), g_const, g_const,
            P(None, None, None),
            g_const, g_const,
            g_const, P(None), g_const,
            P(None), P(None),
        ),
        out_specs=data,
        check_vma=False,
    )
    return jax.jit(fn)


def shard_stage(mesh: Mesh, fn, data_argnums, **kwargs):
    """Generic transparent sharding for an engine pipeline stage.

    ``fn`` is a jitted stage over [B, ...] batch arrays plus replicated
    constants; the args listed in ``data_argnums`` are sharded on their
    leading axis over the mesh's 'batch' axis (which must divide B — the
    engines pad to tile*ndev), everything else (scalars, const arrays,
    constant dicts) is replicated.  Outputs are [B, ...] and come back
    batch-sharded, so chained stages never gather.  The jitted program is
    built once per (mesh, stage, static kwargs) and reused across calls.

    This is what makes `initialize_context` + a >1-device mesh turn the
    public PublicKey.encrypt / PrivateKey.decrypt APIs into multi-device
    programs with no manual shard_map plumbing (SURVEY.md §2.5).
    """
    return _sharded_stage(
        mesh, fn, frozenset(data_argnums), tuple(sorted(kwargs.items()))
    )


@functools.lru_cache(maxsize=None)
def _sharded_stage(mesh: Mesh, fn, data_argnums, kwargs):
    bound = functools.partial(fn, **dict(kwargs)) if kwargs else fn

    def call(*args):
        # pytree-prefix specs: P("batch") splits every leaf's leading axis,
        # P() replicates a whole argument (dicts of constants included)
        in_specs = tuple(
            P("batch") if i in data_argnums else P() for i in range(len(args))
        )
        return jax.shard_map(
            bound, mesh=mesh, in_specs=in_specs, out_specs=P("batch"),
            check_vma=False,
        )(*args)

    return jax.jit(call)


def shard_batch(arr, mesh: Mesh):
    """Place a [B, ...] host array with its batch dim sharded over all mesh
    devices (input distribution; the only 'communication' in the design)."""
    axes = (
        ("crt", "batch") if "crt" in mesh.axis_names else ("batch",)
    )
    spec = P(axes, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))

