"""Per-key device engines: codec + batch padding + jitted pipeline dispatch.

The engine owns the precomputed device constants for one key (the analog of
the per-key state the reference precomputes in PublicKey/PrivateKey ctors,
ipcl/pub_key.cpp:18-49 and ipcl/pri_key.cpp:13-37) and converts between host
Python ints and fixed-shape limb tensors around every batched call.

Batch sizes are padded (multiples of BATCH_TILE rows on the RNS backend,
the next power of two on the CIOS backend) so the number of jit
specializations stays bounded (the analog of the reference's chunks-of-8
padding policy, ipcl/mod_exp.cpp:480-516).

Two cross-cutting mechanisms live here:

* **Hybrid batch split** — the reference's QAT/IPP work split
  (ipcl/mod_exp.cpp:688-732): when a hybrid ratio < 1 is set, the head of
  each batch runs on this engine's RNS backend and the tail on a CIOS
  ("xla") twin engine, concatenated on device.  JAX async dispatch runs
  the two pipelines concurrently, as the reference's std::thread did.
* **Transparent mesh sharding** — when a runtime context with a >1-device
  mesh is live (parallel/context.py), every batched pipeline stage runs
  under shard_map with the batch axis split across devices; host uploads
  are placed pre-sharded so input distribution is the only communication.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops import paillier_ops as pops
from ..ops.dispatch import check_backend, default_backend
from ..utils.config import perf_timer
from ..ops.limbs import (
    LIMB_BITS,
    ints_to_bytes_le,
    ints_to_limbs,
    ints_to_windows,
    limbs_for_bits,
    limbs_to_ints,
    max_bitlength,
    num_windows,
    pack_pairs_np,
    unpack_pairs_np,
)
from ..ops.montgomery import MontConstants

#: RNS-backend batch padding unit: batches round up to a multiple of this
#: many rows (times the mesh size), bounding the jit variants.
BATCH_TILE = 128


def _download_limbs(dev_arr) -> List[int]:
    """Device canonical limbs -> host ints via a packed (half-size) download.

    Multi-process global arrays (batch sharded across hosts via the context
    mesh) are gathered with an all-gather so every process sees the full
    host view — the only cross-host communication in the design besides
    input distribution (SURVEY.md §2.5)."""
    packed = pops.pack_out_op(dev_arr)
    L = dev_arr.shape[-1]
    if not packed.is_fully_addressable:
        from jax.experimental import multihost_utils

        packed_np = multihost_utils.process_allgather(packed, tiled=True)
    else:
        packed_np = np.asarray(packed)
    return limbs_to_ints(unpack_pairs_np(packed_np, L))


def _perf(op: str):
    """Wrap a public pipeline with the perf-mode wall timer
    (utils/config.perf_timer, the HE_QAT_PERF analog — heqat stamps
    submit->callback the same way, module/heqat/heqat/ctrl.c:497-499).
    JAX dispatch is asynchronous, so this measures host codec + dispatch
    wall time; device time shows up in the final download/sync."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kw):
            x = args[0] if args else next(iter(kw.values()), None)
            if isinstance(x, DevLimbs):
                size = x.size
            else:
                size = getattr(x, "size", None)
                if size is None:
                    try:
                        size = len(x)
                    except TypeError:
                        size = "?"
            with perf_timer(f"{op}[B={size}]"):
                return fn(self, *args, **kw)

        return wrapper

    return deco


class DevLimbs:
    """A device-resident batch of canonical 15-bit limbs [Bp, L] plus the
    live (unpadded) batch size.

    This is what lets chained homomorphic pipelines stay on-chip: every
    engine op accepts and returns DevLimbs, and the host list-of-ints view
    materializes lazily (one packed download) only when .texts is read.
    The reference's analog is keeping BigNumber buffers pinned in QAT NUMA
    memory between calls (module/heqat/heqat/bnops.c:52-146) — here the
    buffers simply stay in HBM as jax.Arrays.
    """

    __slots__ = ("arr", "size")

    def __init__(self, arr, size: int):
        self.arr = arr
        self.size = size

    def fetch(self) -> List[int]:
        with perf_timer(f"download[B={self.size}]"):
            return _download_limbs(self.arr)[: self.size]

    def sync(self) -> None:
        """Block until the producing computation completed on device."""
        self.arr.block_until_ready()


def _pad_batch(
    xs: List[int], fill: int, backend: str = "xla", ndev: int = 1
) -> List[int]:
    """Pad a batch so jit specializations stay bounded.

    CIOS ("xla") backend: next power of two.  RNS backend: next multiple
    of BATCH_TILE.  With a device mesh (``ndev`` > 1) the target
    additionally rounds up so every device gets an equal, tile-aligned
    shard.
    """
    n = len(xs)
    if backend != "xla":
        tile = BATCH_TILE * ndev
        target = -(-n // tile) * tile
    else:
        target = 1 << max(0, (n - 1).bit_length())
        target = -(-target // ndev) * ndev
    return xs + [fill] * (target - n)


def _resolve_backend(backend: Optional[str]) -> str:
    """Explicit choice > runtime context (initialize_context) > autodetect.

    The context hook is the reference's initializeContext("CPU"/"QAT")
    switch (ipcl/utils/context.cpp:16-44): a context initialized with
    "CPU" forces the pure-XLA path for engines created afterwards.
    """
    if backend:
        return check_backend(backend)
    from ..parallel.context import peek_context

    ctx = peek_context()
    if ctx is not None:
        return ctx.backend
    return default_backend()


def _resolve_mesh(mesh):
    """Engine mesh: explicit > context mesh, when it spans >1 device."""
    if mesh is not None:
        return mesh if mesh.devices.size > 1 else None
    from ..parallel.context import peek_context

    ctx = peek_context()
    if ctx is not None and ctx.mesh is not None and ctx.mesh.devices.size > 1:
        return ctx.mesh
    return None


def _is_rns(backend: str) -> bool:
    return backend == "rns"


def _width_backend(backend: str, mod_bits: int) -> str:
    """Downgrade an RNS backend choice to the width-generic CIOS backend
    when the modulus exceeds the prime pool's reach (~8.5k bits with the
    12..14-bit pool; ops/rns.rns_supported).  The full supported key
    envelope (200..4096-bit, n^2 to 8192 bits) stays on RNS — this gate
    only protects hypothetical wider moduli."""
    from ..ops.rns import rns_supported

    if _is_rns(backend) and not rns_supported(mod_bits):
        return "xla"
    return backend


def _round_windows(nw: int) -> int:
    """Round a window count up to a multiple of 8 (bounds jit variants)."""
    return max(8, -(-nw // 8) * 8)


class _EngineCommon:
    """Batch padding, mesh placement, stage sharding, and the hybrid split
    shared by the public and private engines."""

    # -- padding / placement ------------------------------------------------

    def _pad(self, xs, fill: int) -> List[int]:
        return _pad_batch(list(xs), fill, self.backend, self._ndev)

    def _up_arr(self, a):
        """Host [B, ...] batch array -> device, batch-sharded on a mesh."""
        a = np.asarray(a)
        if self.mesh is not None:
            spec = P("batch", *([None] * (a.ndim - 1)))
            return jax.device_put(a, NamedSharding(self.mesh, spec))
        return jnp.asarray(a)

    def _up_limbs(self, ints: Sequence[int], num_limbs: int):
        """Host ints -> device canonical limbs via a packed upload."""
        packed = pack_pairs_np(ints_to_limbs(list(ints), num_limbs))
        return pops.unpack_in_op(self._up_arr(packed), num_limbs)

    def _stage(self, fn, data_argnums=(), **kwargs):
        """A jitted pipeline stage; shard_map'd over the mesh when one is
        set (args listed in ``data_argnums`` are [B, ...] batch-sharded,
        everything else replicated)."""
        if self.mesh is None:
            return functools.partial(fn, **kwargs) if kwargs else fn
        from ..parallel.mesh import shard_stage

        return shard_stage(self.mesh, fn, tuple(data_argnums), **kwargs)

    # -- hybrid split (ipcl/mod_exp.cpp:688-732) ------------------------------

    @property
    def secondary(self):
        """The CIOS ("xla") twin engine for hybrid batch splits (the
        reference's IPP-path analog, ipcl/mod_exp.cpp:727-728)."""
        if self.backend == "xla":
            return self
        if self._secondary is None:
            sec = self._make_secondary()
            sec.mesh = self.mesh
            sec._ndev = self._ndev
            self._secondary = sec
        return self._secondary

    def _hybrid(self, op: str, method: str, size: int, operands):
        """Split a batch at the hybrid ratio: head rows on this engine's
        RNS backend, tail rows on the CIOS twin, concatenated on device
        (JAX async dispatch overlaps the two pipelines, replacing the
        reference's std::thread).  Returns None when no split applies:
        full-primary policy, an xla engine, or device-resident operands
        (which cannot be resliced host-side)."""
        from ..ops.dispatch import hybrid_head_count

        if self.backend == "xla" or any(
            isinstance(o, DevLimbs) for o in operands
        ):
            return None
        nh = hybrid_head_count(op, size, self.backend)
        if nh >= size:
            return None

        def part(o, sl):
            if isinstance(o, np.ndarray):
                return o[sl]
            o = list(o)
            return o if len(o) == 1 and size > 1 else o[sl]  # shared scalar

        tail = getattr(self.secondary, method)(
            *[part(o, slice(nh, size)) for o in operands]
        )
        if nh == 0:
            arr = tail.arr[: tail.size]
        else:
            head = getattr(self, method)(
                *[part(o, slice(0, nh)) for o in operands]
            )
            arr = jnp.concatenate(
                [head.arr[: head.size], tail.arr[: tail.size]]
            )
        Bp = len(self._pad([0] * size, 0))
        if arr.shape[0] < Bp:  # re-pad (value 1) to the padded batch shape
            pad = jnp.zeros((Bp - size, arr.shape[-1]), jnp.uint32)
            arr = jnp.concatenate([arr, pad.at[:, 0].set(1)])
        return DevLimbs(arr, size)


class PublicEngine(_EngineCommon):
    """Device pipelines for one public key."""

    def __init__(
        self,
        n: int,
        bits: int,
        hs: Optional[int],
        randbits: int,
        backend: Optional[str] = None,
        mesh=None,
    ):
        self.nbits = n.bit_length()
        self.backend = _width_backend(_resolve_backend(backend), 2 * self.nbits)
        self.mesh = _resolve_mesh(mesh)
        self._ndev = int(self.mesh.devices.size) if self.mesh is not None else 1
        self._secondary: Optional["PublicEngine"] = None
        self.n = n
        self.nsquare = n * n
        self.Ln = limbs_for_bits(self.nbits)
        self.mont_n2 = MontConstants.create(self.nsquare, 2 * self.nbits)
        self.L2 = self.mont_n2.num_limbs
        self.n_limbs = jnp.asarray(ints_to_limbs([n], self.Ln)[0])
        self.n2_args = self.mont_n2.as_device_args()  # (n, n0inv, r2, one)
        # shared exponent n as windows for the normal obfuscator r^n mod n^2
        self.n_wins = jnp.asarray(ints_to_windows([n], self.nbits))
        self.randbits = randbits
        self.hs_int = hs
        self.hs_limbs = (
            jnp.asarray(ints_to_limbs([hs], self.L2)[0]) if hs is not None else None
        )

        self._rns = None
        self._fb = None

    def _make_secondary(self) -> "PublicEngine":
        return PublicEngine(
            self.n, self.nbits, self.hs_int, self.randbits, backend="xla"
        )

    def set_hs(self, hs: int, randbits: Optional[int] = None) -> None:
        """Install new DJN parameters.  ``randbits`` must accompany a
        late enable_djn/set_djn (ipcl/pub_key.cpp:131-137): the fixed-base
        table is sized from it, and an engine created before DJN was
        enabled would otherwise keep a stale obfuscator width."""
        self.hs_int = hs
        self.hs_limbs = jnp.asarray(ints_to_limbs([hs], self.L2)[0])
        if randbits is not None:
            self.randbits = randbits
        self._rns = None  # hs residues must be rebuilt
        self._fb = None  # table is sized from randbits and built from hs
        self._fb_mask = None  # byte mask is sized from randbits
        self._secondary = None  # the xla twin re-derives hs on next use

    @property
    def rns(self):
        """Lazy RNS constants for n^2 (RNSContext.device_consts())."""
        if self._rns is None:
            from ..ops.rns import RNSContext

            ctx = RNSContext.create(self.nsquare, in_limbs=self.L2)
            self._rns = ctx.device_consts()
        return self._rns

    @property
    def fixedbase(self):
        """Lazy per-key fixed-base table for hs^r (ops/rns.py
        fb_table_planes): (planes, NP).  Built once per key: a host square
        chain g_i = hs^(2^(8 i)) mod n^2 feeds the device table build."""
        if self._fb is None:
            from ..ops.rns import fb_num_windows

            NP = fb_num_windows(self.randbits)
            g = [self.hs_int % self.nsquare]
            for _ in range(NP - 1):
                g.append(pow(g[-1], 256, self.nsquare))
            g_limbs = jnp.asarray(ints_to_limbs(g, self.L2))
            self._fb = (pops.fb_table_stage(g_limbs, self.rns), NP)
        return self._fb

    # -- operand normalization ------------------------------------------------

    def _upload_narrow(self, xs: List[int]):
        """Upload a batch using only the limbs that cover its widest value
        (rounded to 8 to bound jit variants) — plaintexts are usually tiny
        compared to n, so this shrinks the wire + codec cost ~17x."""
        lm = -(-max_bitlength(xs) // LIMB_BITS)  # limbs covering widest value
        Lm = min(self.Ln, max(8, -(-lm // 8) * 8))
        return self._up_arr(ints_to_limbs(xs, Lm))

    def _ct_operand(self, x, fill: int):
        """CipherText operand (DevLimbs or int list) -> ([Bp, L2] array, size)."""
        if isinstance(x, DevLimbs):
            return x.arr, x.size
        xs = self._pad(x, fill)
        if self.backend == "xla" and self.mesh is None:
            return jnp.asarray(ints_to_limbs(xs, self.L2)), len(x)
        return self._up_limbs(xs, self.L2), len(x)

    # -- pipelines ----------------------------------------------------------
    #
    # Every pipeline returns DevLimbs (device-resident canonical limbs);
    # legacy list-returning wrappers materialize immediately.  The *_dev
    # entry points apply the hybrid split, then forward to the _impl
    # pipelines.

    def _seed_fallback(self, r, size: int, op: str, normal: bool = False):
        """Materialize a DeviceSeed into a host draw for paths that cannot
        expand on device: hybrid batch splits (the seed cannot be row-
        sliced) and the CIOS backend.  Sharded meshes DO expand on
        device — each shard gets its own seed row (_seed_rows), so
        shards draw independent ChaCha20 keystreams.  ``normal`` draws
        normal-mode obfuscator bases r in [1, n-1] instead of DJN
        exponent bytes."""
        from ..ops.dispatch import hybrid_head_count
        from ..utils.rng import DeviceSeed

        if not isinstance(r, DeviceSeed):
            return r
        if (
            not _is_rns(self.backend)
            or hybrid_head_count(op, size, self.backend) < size
        ):
            if normal:
                from ..utils import rng as _rng

                return [
                    v % (self.n - 1) + 1
                    for v in _rng.batch_random_bits(size, self.nbits)
                ]
            return r.materialize(size, self.randbits)
        return r

    def _seed_rows(self, r):
        """[S, 11] uint32 seed rows, one per mesh device (row i keys
        device i's shard; S=1 without a mesh), batch-sharded so each
        shard reads only its own row."""
        from ..utils.rng import DeviceSeed

        rows = np.stack(
            [r.data]
            + [DeviceSeed().data for _ in range(self._ndev - 1)]
        )
        return self._up_arr(rows)

    @property
    def fb_mask(self):
        """[NP] uint8 byte mask for device-generated obfuscator exponents
        (0xFF for full randbits bytes, a partial top byte, 0 beyond)."""
        if getattr(self, "_fb_mask", None) is None:
            _, NP = self.fixedbase
            nbytes = -(-self.randbits // 8)
            mask = np.zeros((NP,), np.uint8)
            mask[:nbytes] = 0xFF
            top = self.randbits % 8
            if top:
                mask[nbytes - 1] = (1 << top) - 1
            self._fb_mask = jnp.asarray(mask)
        return self._fb_mask

    @_perf("encrypt_djn")
    def encrypt_djn_dev(self, m: Sequence[int], r) -> DevLimbs:
        r = self._seed_fallback(r, len(m), "encrypt")
        out = self._hybrid("encrypt", "_encrypt_djn_impl", len(m), (m, r))
        return out if out is not None else self._encrypt_djn_impl(m, r)

    def _encrypt_djn_impl(self, m: Sequence[int], r) -> DevLimbs:
        """``r`` is a list of ints (injected test randoms), a [B, nbytes]
        uint8 array from the OS CSPRNG (utils/rng.batch_random_bytes), or
        a utils/rng.DeviceSeed — the fast path expands the seed on
        device, so fresh-obfuscator encryption uploads 44 seed bytes per shard instead
        of the full exponent byte matrix."""
        from ..utils.rng import DeviceSeed

        size = len(m)
        m_p = self._pad(m, 0)
        r_is_seed = isinstance(r, DeviceSeed)
        r_is_bytes = isinstance(r, np.ndarray) and r.dtype == np.uint8
        if r_is_bytes and not _is_rns(self.backend):
            # the CIOS backend takes window-encoded ints: decode once
            r = [
                int.from_bytes(row.tobytes(), "little") for row in r
            ]
            r_is_bytes = False
        if r_is_bytes or r_is_seed:
            r_p, ebits = None, self.randbits
        else:
            r_p = self._pad(r, 0)
            ebits = max(self.randbits, max_bitlength(r_p))
        nw = _round_windows(num_windows(ebits))
        m_a = self._upload_narrow(m_p)
        n2_n, n2_n0inv, n2_r2, n2_one = self.n2_args
        if _is_rns(self.backend):
            conv = self.rns
            planes, NP = self.fixedbase
            if r_is_seed:
                # on-device exponent expansion + fixed-base modexp +
                # embedding + obfuscation multiply + finalize in ONE
                # jitted program; the seed rows are batch-sharded (one
                # per device)
                out = self._stage(pops.encrypt_fb_fused_rng_stage, (1, 3))(
                    planes, self._seed_rows(r), self.fb_mask, m_a,
                    self.n_limbs, conv, n2_n,
                )
                return DevLimbs(out, size)
            if -(-ebits // 8) <= NP:  # exponents fit the table
                if r_is_bytes:
                    rb = np.zeros((len(m_p), NP), np.uint8)
                    rb[: r.shape[0], : r.shape[1]] = r
                    r_b = self._up_arr(rb)
                else:
                    r_b = self._up_arr(ints_to_bytes_le(r_p, NP))
                # fixed-base modexp + embedding + obfuscation multiply +
                # finalize in ONE jitted program
                out = self._stage(pops.encrypt_fb_fused_stage, (1, 2))(
                    planes, r_b, m_a, self.n_limbs, conv, n2_n
                )
                return DevLimbs(out, size)
            # injected oversized exponents: variable-base fallback
            r_w = self._up_arr(ints_to_windows(r_p, nw * 4))
            hs_b = jnp.broadcast_to(self.hs_limbs, (len(m_p), self.L2))
            res = self._stage(pops.rns_modexp_stage, (0, 1))(hs_b, r_w, conv)
            out = self._stage(pops.encrypt_post_stage, (0, 1))(
                res, m_a, self.n_limbs, conv, n2_n
            )
            return DevLimbs(out, size)
        r_w = self._up_arr(ints_to_windows(r_p, nw * 4))
        out = self._stage(pops.encrypt_djn_op, (0, 1))(
            m_a, r_w, self.n_limbs, n2_n, n2_n0inv, n2_r2, n2_one,
            self.hs_limbs,
        )
        return DevLimbs(out, size)

    @_perf("encrypt_normal")
    def encrypt_normal_dev(self, m: Sequence[int], r) -> DevLimbs:
        r = self._seed_fallback(r, len(m), "encrypt", normal=True)
        out = self._hybrid("encrypt", "_encrypt_normal_impl", len(m), (m, r))
        return out if out is not None else self._encrypt_normal_impl(m, r)

    def _encrypt_normal_impl(self, m, r) -> DevLimbs:
        from ..utils.rng import DeviceSeed

        size = len(m)
        m_p = self._pad(m, 0)
        m_a = self._upload_narrow(m_p)
        n2_n, n2_n0inv, n2_r2, n2_one = self.n2_args
        if isinstance(r, DeviceSeed):  # rns backend guaranteed by fallback
            # ONE jitted program: on-device unreduced base generation
            # ((r + kn)^n ≡ r^n mod n^2) + shared-exponent modexp + post
            out = self._stage(
                pops.encrypt_normal_rng_stage, (0, 1),
                ebits=2 * self.nbits + 3,
            )(self._seed_rows(r), m_a, self.n_wins, self.n_limbs,
              self.rns, n2_n)
            return DevLimbs(out, size)
        r_p = self._pad(r, 1)
        r_a = self._up_arr(ints_to_limbs(r_p, self.L2))
        if _is_rns(self.backend):
            # the exponent (n) is shared by every row: [1, NW] windows
            res = self._stage(pops.rns_modexp_stage, (0,))(
                r_a, self.n_wins, self.rns
            )
            out = self._stage(pops.encrypt_post_stage, (0, 1))(
                res, m_a, self.n_limbs, self.rns, n2_n
            )
            return DevLimbs(out, size)
        out = self._stage(pops.encrypt_normal_op, (0, 1))(
            m_a, r_a, self.n_wins, self.n_limbs, n2_n, n2_n0inv, n2_r2, n2_one
        )
        return DevLimbs(out, size)

    @_perf("obfuscate")
    def obfuscate_dev(self, ct, r) -> DevLimbs:
        size = ct.size if isinstance(ct, DevLimbs) else len(ct)
        r = self._seed_fallback(r, size, "encrypt")
        out = self._hybrid("encrypt", "_obfuscate_impl", size, (ct, r))
        return out if out is not None else self._obfuscate_impl(ct, r)

    def _obfuscate_impl(self, ct, r) -> DevLimbs:
        """Standalone re-obfuscation: ct * hs^r (DJN, ipcl/pub_key.cpp:51-64)
        or ct * r^n (normal, :66-80) mod n^2.  ``ct`` is DevLimbs or a host
        int list; ``r`` follows encrypt_djn_dev's conventions."""
        from ..utils.rng import DeviceSeed

        ct_a, size = self._ct_operand(ct, 1)
        B = ct_a.shape[0]
        n2_n, n2_n0inv, n2_r2, n2_one = self.n2_args
        if self.hs_limbs is not None:  # DJN: obf = hs^r
            r_is_seed = isinstance(r, DeviceSeed)
            r_is_bytes = isinstance(r, np.ndarray) and r.dtype == np.uint8
            if r_is_bytes and not _is_rns(self.backend):
                r = [int.from_bytes(row.tobytes(), "little") for row in r]
                r_is_bytes = False
            if r_is_bytes or r_is_seed:
                r_p, ebits = None, self.randbits
            else:
                r_p = self._pad(r, 0)
                ebits = max(self.randbits, max_bitlength(r_p))
            if _is_rns(self.backend):
                conv = self.rns
                planes, NP = self.fixedbase
                if r_is_seed:
                    out = self._stage(
                        pops.obfuscate_fb_fused_rng_stage, (1, 3)
                    )(planes, self._seed_rows(r), self.fb_mask, ct_a,
                      conv, n2_n)
                    return DevLimbs(out, size)
                if -(-ebits // 8) <= NP:
                    if r_is_bytes:
                        rb = np.zeros((B, NP), np.uint8)
                        rb[: r.shape[0], : r.shape[1]] = r
                        r_b = self._up_arr(rb)
                    else:
                        r_b = self._up_arr(ints_to_bytes_le(r_p, NP))
                    res = self._stage(
                        pops.rns_fb_modexp_stage, (1,), mont_out=True
                    )(planes, r_b, conv)
                    res_mont = True
                else:
                    nw = _round_windows(num_windows(ebits))
                    r_w = self._up_arr(ints_to_windows(r_p, nw * 4))
                    hs_b = jnp.broadcast_to(self.hs_limbs, (B, self.L2))
                    res = self._stage(pops.rns_modexp_stage, (0, 1))(
                        hs_b, r_w, conv
                    )
                    res_mont = False
                out = self._stage(
                    pops.mul_res_post_stage, (0, 1), res_mont=res_mont
                )(ct_a, res, conv, n2_n)
                return DevLimbs(out, size)
            nw = _round_windows(num_windows(ebits))
            r_w = self._up_arr(ints_to_windows(r_p, nw * 4))
            out = self._stage(pops.obfuscate_op, (0, 2))(
                ct_a, self.hs_limbs, r_w, n2_n, n2_n0inv, n2_r2, n2_one
            )
            return DevLimbs(out, size)
        # normal mode: obf = r^n, shared exponent n
        r_p = self._pad(r, 1)
        r_a = self._up_arr(ints_to_limbs(r_p, self.L2))
        if _is_rns(self.backend):
            res = self._stage(pops.rns_modexp_stage, (0,))(
                r_a, self.n_wins, self.rns
            )
            out = self._stage(pops.mul_res_post_stage, (0, 1))(
                ct_a, res, self.rns, n2_n
            )
            return DevLimbs(out, size)
        out = self._stage(pops.obfuscate_op, (0, 1))(
            ct_a, r_a, self.n_wins, n2_n, n2_n0inv, n2_r2, n2_one
        )
        return DevLimbs(out, size)

    @_perf("encrypt_noobf")
    def encrypt_noobf_dev(self, m: Sequence[int]) -> DevLimbs:
        size = len(m)
        m_p = self._pad(m, 0)
        m_a = self._upload_narrow(m_p)
        out = self._stage(pops.encrypt_noobf_op, (0,))(
            m_a, self.n_limbs, self.n2_args[0]
        )
        return DevLimbs(out, size)

    @_perf("add_ctct")
    def add_ctct_dev(self, a, b) -> DevLimbs:
        a_a, size = self._ct_operand(a, 0)
        b_a, b_size = self._ct_operand(b, 1)
        if b_size == 1 and size != 1:
            b_a = jnp.broadcast_to(b_a[:1], a_a.shape)
        n2_n, n2_n0inv, n2_r2, _ = self.n2_args
        if _is_rns(self.backend):
            out = self._stage(pops.add_ctct_rns_op, (0, 1))(
                a_a, b_a, self.rns, n2_n
            )
            return DevLimbs(out, size)
        out = self._stage(pops.add_ctct_op, (0, 1))(
            a_a, b_a, n2_n, n2_n0inv, n2_r2
        )
        return DevLimbs(out, size)

    @_perf("mul_ctpt")
    def mul_ctpt_dev(self, ct, pt: Sequence[int]) -> DevLimbs:
        out = self._hybrid(
            "multiply", "_mul_ctpt_impl",
            ct.size if isinstance(ct, DevLimbs) else len(ct), (ct, pt),
        )
        return out if out is not None else self._mul_ctpt_impl(ct, pt)

    def _mul_ctpt_impl(self, ct, pt: Sequence[int]) -> DevLimbs:
        ct_a, size = self._ct_operand(ct, 1)
        # a scalar PT keeps its size-1 row: one [1, NW] shared exponent
        # (detected BEFORE padding, which would hide it behind a full tile)
        shared_pt = len(pt) == 1 and ct_a.shape[0] != 1
        pt_p = list(pt) if shared_pt else self._pad(pt, 0)
        nw = _round_windows(num_windows(max_bitlength(pt_p)))
        pt_w = ints_to_windows(pt_p, nw * 4)
        n2_n, n2_n0inv, n2_r2, n2_one = self.n2_args
        if _is_rns(self.backend):
            if shared_pt:  # one plaintext scalar: one shared exponent
                res = self._stage(pops.rns_modexp_stage, (0,))(
                    ct_a, jnp.asarray(pt_w), self.rns
                )
            else:
                res = self._stage(pops.rns_modexp_stage, (0, 1))(
                    ct_a, self._up_arr(pt_w), self.rns
                )
            out = self._stage(
                pops.rns_finalize_stage, (0,), out_limbs=self.L2
            )(res, self.rns, n2_n)
            return DevLimbs(out, size)
        if shared_pt:
            pt_w = np.broadcast_to(
                np.asarray(pt_w), (ct_a.shape[0], np.asarray(pt_w).shape[-1])
            )
        out = self._stage(pops.mul_ctpt_op, (0, 1))(
            ct_a, self._up_arr(pt_w), n2_n, n2_n0inv, n2_r2, n2_one
        )
        return DevLimbs(out, size)

    # -- legacy list-returning wrappers --------------------------------------

    def encrypt_djn(self, m, r) -> List[int]:
        return self.encrypt_djn_dev(m, r).fetch()

    def encrypt_normal(self, m, r) -> List[int]:
        return self.encrypt_normal_dev(m, r).fetch()

    def encrypt_noobf(self, m) -> List[int]:
        return self.encrypt_noobf_dev(m).fetch()

    def add_ctct(self, a, b) -> List[int]:
        return self.add_ctct_dev(a, b).fetch()

    def mul_ctpt(self, ct, pt) -> List[int]:
        return self.mul_ctpt_dev(ct, pt).fetch()


class PrivateEngine(_EngineCommon):
    """Device pipelines for one private key (CRT + RAW decrypt)."""

    def __init__(
        self,
        n: int,
        p: int,
        q: int,
        lam: int,
        x: int,
        hp: int,
        hq: int,
        backend: Optional[str] = None,
        mesh=None,
    ):
        assert p < q
        pbits = max(p.bit_length(), q.bit_length())
        # CRT decrypt runs at p^2/q^2 width (RNS reaches every supported
        # key size); the RAW path gates on n^2 width per call
        self.backend = _width_backend(_resolve_backend(backend), 2 * pbits)
        self.mesh = _resolve_mesh(mesh)
        self._ndev = int(self.mesh.devices.size) if self.mesh is not None else 1
        self._secondary: Optional["PrivateEngine"] = None
        self.n = n
        self.nbits = n.bit_length()
        self.Lp = limbs_for_bits(pbits)
        self.mont_p2 = MontConstants.create(p * p, 2 * pbits)
        self.mont_q2 = MontConstants.create(q * q, 2 * pbits)
        self.Lp2 = self.mont_p2.num_limbs
        assert self.mont_q2.num_limbs == self.Lp2
        self.mont_p = MontConstants.create(p, pbits)
        self.mont_q = MontConstants.create(q, pbits)
        assert self.mont_q.num_limbs == self.Lp

        def stack(attr_p, attr_q):
            return jnp.asarray(np.stack([attr_p, attr_q]))

        self.sq_n = stack(self.mont_p2.n_limbs, self.mont_q2.n_limbs)
        self.sq_n0inv = jnp.asarray(
            np.array([self.mont_p2.n0inv, self.mont_q2.n0inv], np.uint32)
        )
        self.sq_r2 = stack(self.mont_p2.r2_limbs, self.mont_q2.r2_limbs)
        self.sq_one = stack(self.mont_p2.one_limbs, self.mont_q2.one_limbs)
        ewbits = _round_windows(num_windows(pbits)) * 4
        self.exp_wins = jnp.asarray(
            np.stack(
                [ints_to_windows([p - 1], ewbits), ints_to_windows([q - 1], ewbits)]
            )
        )  # [2, 1, NW]
        R_lp = 1 << (LIMB_BITS * self.Lp)
        self.hensel = stack(
            ints_to_limbs([pow(p, -1, R_lp)], self.Lp)[0],
            ints_to_limbs([pow(q, -1, R_lp)], self.Lp)[0],
        )
        self.hfun = stack(
            ints_to_limbs([hp], self.Lp)[0], ints_to_limbs([hq], self.Lp)[0]
        )
        self.pq_n = stack(self.mont_p.n_limbs, self.mont_q.n_limbs)
        self.pq_n0inv = jnp.asarray(
            np.array([self.mont_p.n0inv, self.mont_q.n0inv], np.uint32)
        )
        self.pq_r2 = stack(self.mont_p.r2_limbs, self.mont_q.r2_limbs)
        self.pinv_q = jnp.asarray(ints_to_limbs([pow(p, -1, q)], self.Lp)[0])
        self.p_limbs = jnp.asarray(ints_to_limbs([p], self.Lp)[0])

        # RAW-mode constants (lambda exponent over n^2, then L-function by n)
        self.mont_n2 = MontConstants.create(n * n, 2 * self.nbits)
        self.mont_n = MontConstants.create(n, self.nbits)
        self.Ln = self.mont_n.num_limbs
        lam_bits = _round_windows(num_windows(self.nbits)) * 4
        self.lam_wins = jnp.asarray(ints_to_windows([lam], lam_bits))
        R_ln = 1 << (LIMB_BITS * self.Ln)
        self.hensel_n = jnp.asarray(ints_to_limbs([pow(n, -1, R_ln)], self.Ln)[0])
        self.x_limbs = jnp.asarray(ints_to_limbs([x], self.Ln)[0])
        self._p, self._q, self._pbits = p, q, pbits
        self._lam, self._x, self._hp, self._hq = lam, x, hp, hq
        self._rns_crt = None
        self._rns_raw = None

    def _make_secondary(self) -> "PrivateEngine":
        return PrivateEngine(
            self.n, self._p, self._q, self._lam, self._x, self._hp, self._hq,
            backend="xla",
        )

    @property
    def rns_crt(self):
        """RNS constants for CRT decrypt: the (p^2, q^2) contexts'
        device_consts stacked on a leading G=2 axis.

        in_limbs spans the FULL n^2-width ciphertext (2*Lp2): the Cin
        weights (2^(15 l) mod h^2) mod m fold ct into each residue
        system inside the input-conversion matmul, so decrypt has no
        separate "ct mod p^2" stage.  The represented value is
        V < 2*Lp2 * 2^15 * N; product_bits sizes M_A >= 2^26 * N above
        it so the first to-Montgomery multiply contracts
        V*N/M_A + 2N < 3N.  The shared product_bits also gives both
        contexts the same prime bases, hence stackable constants."""
        if self._rns_crt is None:
            from ..ops.rns import RNSContext

            in_limbs = 2 * self.Lp2
            bits = 2 * self._pbits + LIMB_BITS + in_limbs.bit_length() + 1
            cp, cq = (
                RNSContext.create(h * h, in_limbs=in_limbs, product_bits=bits)
                for h in (self._p, self._q)
            )
            host_p, host_q = cp.host_consts(), cq.host_consts()
            self._rns_crt = {
                k: jnp.asarray(np.stack([host_p[k], host_q[k]])) for k in host_p
            }
        return self._rns_crt

    @property
    def rns_raw(self):
        """RNS constants for the RAW path (modulus n^2)."""
        if self._rns_raw is None:
            from ..ops.rns import RNSContext

            ctx = RNSContext.create(
                self.n * self.n, in_limbs=self.mont_n2.num_limbs
            )
            self._rns_raw = ctx.device_consts()
        return self._rns_raw

    def _ct_operand(self, ct, width: int):
        """Decrypt input (DevLimbs or int list) -> ([Bp, width] array, size)."""
        if isinstance(ct, DevLimbs):
            arr, size = ct.arr, ct.size
            pad = width - arr.shape[-1]
            if pad > 0:
                arr = jnp.concatenate(
                    [arr, jnp.zeros(arr.shape[:-1] + (pad,), jnp.uint32)], -1
                )
            elif pad < 0:
                raise ValueError("ciphertext limbs wider than decrypt expects")
            return arr, size
        ct_p = self._pad(ct, 1)
        if self.backend != "xla" or self.mesh is not None:
            return self._up_limbs(ct_p, width), len(ct)
        return jnp.asarray(ints_to_limbs(ct_p, width)), len(ct)

    @_perf("decrypt_crt")
    def decrypt_crt_dev(self, ct) -> DevLimbs:
        out = self._hybrid(
            "decrypt", "_decrypt_crt_impl",
            ct.size if isinstance(ct, DevLimbs) else len(ct), (ct,),
        )
        return out if out is not None else self._decrypt_crt_impl(ct)

    def _decrypt_crt_impl(self, ct) -> DevLimbs:
        ct_a, size = self._ct_operand(ct, 2 * self.Lp2)
        if _is_rns(self.backend):
            out = self._stage(pops.decrypt_crt_rns_op, (0,))(
                ct_a,
                self.sq_n,
                self.exp_wins, self.hensel, self.hfun,
                self.pq_n, self.pq_n0inv, self.pq_r2,
                self.pinv_q, self.p_limbs,
                self.rns_crt,
            )
        else:
            out = self._stage(pops.decrypt_crt_op, (0,))(
                ct_a,
                self.sq_n,
                self.sq_n0inv,
                self.sq_r2,
                self.sq_one,
                self.exp_wins,
                self.hensel,
                self.hfun,
                self.pq_n,
                self.pq_n0inv,
                self.pq_r2,
                self.pinv_q,
                self.p_limbs,
            )
        return DevLimbs(out, size)

    @_perf("decrypt_raw")
    def decrypt_raw_dev(self, ct) -> DevLimbs:
        out = self._hybrid(
            "decrypt", "_decrypt_raw_impl",
            ct.size if isinstance(ct, DevLimbs) else len(ct), (ct,),
        )
        return out if out is not None else self._decrypt_raw_impl(ct)

    def _decrypt_raw_impl(self, ct) -> DevLimbs:
        ct_a, size = self._ct_operand(ct, self.mont_n2.num_limbs)
        n2_n, n2_n0inv, n2_r2, n2_one = self.mont_n2.as_device_args()
        n_n, n_n0inv, n_r2, _ = self.mont_n.as_device_args()
        # RAW runs at n^2 width, which may exceed the RNS pool's reach
        # even when the CRT path (p^2 width) is on RNS
        if _is_rns(_width_backend(self.backend, 2 * self.nbits)):
            conv = self.rns_raw
            res_r = self._stage(pops.rns_modexp_stage, (0,))(
                ct_a, self.lam_wins, conv
            )
            res = self._stage(
                pops.rns_finalize_stage, (0,), out_limbs=n2_n.shape[-1]
            )(res_r, conv, n2_n)
            out = self._stage(pops.hensel_post_stage, (0,))(
                res, self.hensel_n, self.x_limbs, n_n, n_n0inv, n_r2
            )
        else:
            out = self._stage(pops.decrypt_raw_op, (0,))(
                ct_a,
                self.lam_wins,
                n2_n,
                n2_n0inv,
                n2_r2,
                n2_one,
                self.hensel_n,
                self.x_limbs,
                n_n,
                n_n0inv,
                n_r2,
            )
        return DevLimbs(out, size)

    # -- legacy list-returning wrappers --------------------------------------

    def decrypt_crt(self, ct) -> List[int]:
        return self.decrypt_crt_dev(ct).fetch()

    def decrypt_raw(self, ct) -> List[int]:
        return self.decrypt_raw_dev(ct).fetch()
