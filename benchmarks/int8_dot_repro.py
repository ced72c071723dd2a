#!/usr/bin/env python
"""Reproducer: int8 digit planes in the CRT decrypt tail.

``ops/bigint.mul_shared`` (the Toeplitz product behind the Hensel
L-function and the CRT recombine) once evaluated its 7-bit digit planes as
int8 x int8 -> int32 dots.  On an H100 with JAX 0.9.0 the CRT decrypt then
returned wrong plaintexts for every row at batch 2048 and right ones at
batch 128; the package now uses bf16 planes with f32 accumulation.  This
script runs the pieces of that tail with both plane types and counts the
wrong rows against Python integers, so the fault can be cornered with
XLA flags:

    python benchmarks/int8_dot_repro.py [--batches 128,2048]
        [--planes int8,bf16] [--hlo DIR]
    XLA_FLAGS=--xla_gpu_enable_triton_gemm=false python benchmarks/int8_dot_repro.py

Pieces, each one jitted program at 2048-bit keys:
  mul_low     the vmapped L-function (r - 1) * h^-1 mod 2^(15 Lp), [2, B, Lp2]
  mul_shared  the CRT recombine product u * p, [B, Lp] x [Lp]
  tail        paillier_ops._crt_tail, the whole L-function + CRT tail
  decrypt     paillier_ops.decrypt_crt_rns_op, the default CRT decrypt

One JSON line per (batch, piece, planes) carries the count of wrong rows
and the device stamp.  ``--hlo DIR`` writes each int8 program's optimized
HLO there, to see which GEMM emitter (cuBLAS, cuBLASLt, Triton) got the
s8 dots.  The script reports and never judges: it exits 0 whatever the
counts are.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import pailliercryptolib_tpu as ptpu  # noqa: E402
from pailliercryptolib_tpu.ops import bigint  # noqa: E402
from pailliercryptolib_tpu.ops import limbs as lb  # noqa: E402
from pailliercryptolib_tpu.ops import paillier_ops as pops  # noqa: E402
from pailliercryptolib_tpu.ops.limbs import LIMB_BITS  # noqa: E402
from pailliercryptolib_tpu.ops.montgomery import canonicalize  # noqa: E402
from pailliercryptolib_tpu.utils.config import enable_compile_cache  # noqa: E402
from pailliercryptolib_tpu.utils.devinfo import device_stamp  # noqa: E402

_U32 = jnp.uint32
PIECES = ("mul_low", "mul_shared", "tail", "decrypt")


def mul_shared_int8(a, x):
    """bigint.mul_shared with int8 planes and int32 accumulation (sums
    <= 127^2 * Lx < 2^31: exact in integer arithmetic)."""
    La, Lx = a.shape[-1], x.shape[-1]
    Lo = La + Lx
    idx = jnp.arange(Lo, dtype=jnp.int32)[None, :] - jnp.arange(
        Lx, dtype=jnp.int32
    )[:, None]
    valid = (idx >= 0) & (idx < La)
    T = jnp.where(valid, a[jnp.clip(idx, 0, La - 1)], _U32(0))  # [Lx, Lo]

    def planes3(v):
        return tuple(
            ((v >> _U32(7 * i)) & _U32(127 if i < 2 else 3))
            .astype(jnp.int32).astype(jnp.int8)
            for i in range(3)
        )

    xp, Tp = planes3(x), planes3(T)
    S = [None] * 5
    for i in range(3):
        for j in range(3):
            prod = jax.lax.dot_general(
                xp[i], Tp[j], (((xp[i].ndim - 1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            ).astype(_U32)
            S[i + j] = prod if S[i + j] is None else S[i + j] + prod
    acc = jnp.zeros(x.shape[:-1] + (Lo,), _U32)

    def shift_cols(arr, by):
        if by == 0:
            return arr
        pad = jnp.zeros(arr.shape[:-1] + (by,), _U32)
        return jnp.concatenate([pad, arr[..., :-by]], axis=-1)

    for s, plane in enumerate(S):
        col, r = divmod(7 * s, LIMB_BITS)
        lo_part = (plane & _U32((1 << (LIMB_BITS - r)) - 1)) << _U32(r)
        hi_part = plane >> _U32(LIMB_BITS - r)
        acc = acc + shift_cols(lo_part, col) + shift_cols(hi_part, col + 1)
    return canonicalize(acc)


@contextlib.contextmanager
def planes(kind):
    """Trace with int8 planes in bigint.mul_shared (and so in mul_low and
    the CRT tail) while the block is open; bf16 is the package's own."""
    saved = bigint.mul_shared, pops.mul_shared
    if kind == "int8":
        bigint.mul_shared = pops.mul_shared = mul_shared_int8
    try:
        yield
    finally:
        bigint.mul_shared, pops.mul_shared = saved


def programs(priv):
    """piece -> (function, fixed trailing arguments); each is jitted anew
    per plane type so the tracing sees the patched mul_shared."""
    Lp = priv.Lp

    def lfun(res, hensel):
        return jax.vmap(
            lambda r, h: bigint.mul_low(h, bigint.sub_scalar(r, 1), Lp)
        )(res, hensel)

    return {
        "mul_low": (lfun, (priv.hensel,)),
        "mul_shared": (lambda u: pops.mul_shared(priv.p_limbs, u), ()),
        "tail": (pops._crt_tail, (
            priv.hensel, priv.hfun, priv.pq_n, priv.pq_n0inv, priv.pq_r2,
            priv.pinv_q, priv.p_limbs,
        )),
        "decrypt": (pops.decrypt_crt_rns_op.__wrapped__, (
            priv.sq_n, priv.exp_wins, priv.hensel, priv.hfun, priv.pq_n,
            priv.pq_n0inv, priv.pq_r2, priv.pinv_q, priv.p_limbs,
            priv.rns_crt,
        )),
    }


def cases(key, batch, rng):
    """piece -> (input array, expected ints) at this batch."""
    pk, sk, priv = key.pub_key, key.priv_key, key.priv_key._engine
    p, q, n, n2 = sk.p, sk.q, pk.n, pk.nsquare
    hp, hq = lb.limbs_to_ints(np.asarray(priv.hfun))
    tp = [rng.randrange(p) for _ in range(batch)]
    tq = [rng.randrange(q) for _ in range(batch)]
    res = np.stack([
        lb.ints_to_limbs([1 + p * t for t in tp], priv.Lp2),
        lb.ints_to_limbs([1 + q * t for t in tq], priv.Lp2),
    ])
    pinv = pow(p, -1, q)
    m_crt = []
    for a, b in zip(tp, tq):
        mp, mq = a * hp % p, b * hq % q
        m_crt.append(mp + (mq - mp) * pinv % q * p)
    u = [rng.randrange(q) for _ in range(batch)]
    m = [rng.randrange(n) for _ in range(batch)]
    obf = [pow(pk.hs, rng.getrandbits(pk.randbits), n2) for _ in range(16)]
    ct = [(n * x + 1) * obf[i % 16] % n2 for i, x in enumerate(m)]
    return {
        "mul_low": (jnp.asarray(res), [tp, tq]),
        "mul_shared": (jnp.asarray(lb.ints_to_limbs(u, priv.Lp)),
                       [x * p for x in u]),
        "tail": (jnp.asarray(res), m_crt),
        "decrypt": (priv._ct_operand(ct, 2 * priv.Lp2)[0], m),
    }


def wrong_rows(out, want):
    out = np.asarray(out)
    if out.ndim == 3:  # mul_low: [2, B, Lp], one expected list per half
        got = [lb.limbs_to_ints(h) for h in out]
        return sum(
            a != b for g, w in zip(got, want) for a, b in zip(g, w)
        )
    got = lb.limbs_to_ints(out)[: len(want)]
    return sum(a != b for a, b in zip(got, want))


def run(key, batches, kinds=("int8", "bf16"), hlo=None):
    """Yield {batch, piece, planes, wrong, rows, s8} for every combination
    (``s8``: the optimized program holds int8 arrays)."""
    progs = programs(key.priv_key._engine)
    rng = random.Random(1)
    for batch in batches:
        inputs = cases(key, batch, rng)
        for piece in PIECES:
            fn, fixed = progs[piece]
            x, want = inputs[piece]
            for kind in kinds:
                # a fresh function per plane type: jit caches traces by
                # function, and the patched mul_shared must be traced anew
                with planes(kind):
                    compiled = jax.jit(lambda *a: fn(*a)).lower(
                        x, *fixed).compile()
                text = compiled.as_text()
                bad = wrong_rows(compiled(x, *fixed), want)
                rows = batch * (2 if piece == "mul_low" else 1)
                yield {"batch": batch, "piece": piece, "planes": kind,
                       "wrong": int(bad), "rows": rows, "s8": "s8[" in text}
                if hlo and kind == "int8":
                    os.makedirs(hlo, exist_ok=True)
                    path = os.path.join(hlo, f"{piece}_{batch}.hlo.txt")
                    with open(path, "w") as f:
                        f.write(text)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default="128,2048")
    ap.add_argument("--planes", default="int8,bf16")
    ap.add_argument("--hlo", metavar="DIR")
    args = ap.parse_args(argv)
    enable_compile_cache()
    stamp = device_stamp()
    stamp["xla_flags"] = os.environ.get("XLA_FLAGS", "")
    key = ptpu.generate_keypair(2048, enable_DJN=True)
    batches = [int(b) for b in args.batches.split(",")]
    for line in run(key, batches, args.planes.split(","), args.hlo):
        print(json.dumps({**line, **stamp}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
