"""Batched Montgomery modular arithmetic in pure JAX/XLA.

Limb-serial replacement for the reference's single hot primitive — batched
modular exponentiation (reference: ipcl/mod_exp.cpp:680-737 dispatching into
``mbx_exp_mb8``, the AVX512-IFMA 8-lane multi-buffer modexp at
ipcl/mod_exp.cpp:446-533, and the per-call Montgomery engine ``ippSBModExp``
at ipcl/mod_exp.cpp:535-585).

Design (nothing here is a translation of the reference's code):

* Numbers are [batch, L] uint32 tensors of 15-bit limbs (see ops/limbs.py).
* ``mont_mul`` is a redundant-digit CIOS (coarsely integrated operand
  scanning): per iteration the partial products are split into 15-bit lo/hi
  halves and accumulated into uint32 column accumulators.  Digits grow to at
  most ~2**26 over the L iterations, so there is **no carry propagation at
  all inside the hot loop** — the vector-unit analog of IFMA's 52-bit-limb
  redundant accumulation.  Two data-independent carry rounds at the end bring
  digits back below 2**15 (inclusive), which is the precondition for the next
  multiplication.  Values stay < 2n throughout ("Montgomery without final
  subtraction", requires R > 4n — guaranteed by GUARD_BITS in limbs.py).
* ``mont_exp`` is a left-to-right fixed 4-bit-window exponentiation with a
  constant-shape one-hot table select — constant-time with respect to the
  exponent bits, and free of data-dependent control flow as XLA requires.
* Full carry/borrow resolution (``canonicalize`` / ``cond_sub_n``) runs
  once per exponentiation, not per multiplication, and uses Kogge–Stone
  carry-lookahead (log-depth elementwise ops) rather than a sequential
  limb scan.

This module is the *correctness oracle* and the CIOS ("xla") backend: the
hybrid-split secondary, the width fallback beyond the RNS prime pool, and
the p-width decrypt tails; the default backend is RNS (ops/rns.py).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .limbs import (
    GUARD_BITS,
    LIMB_BITS,
    LIMB_MASK,
    WINDOW_BITS,
    int_to_limbs,
    limbs_for_bits,
)

_U32 = jnp.uint32


# ---------------------------------------------------------------------------
# Host-side per-modulus constants
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MontConstants:
    """Precomputed Montgomery constants for one modulus (host side).

    The analog of the per-call ``ippsMontGetSize/Init/Set`` engine setup in
    the reference (ipcl/mod_exp.cpp:548-560), but computed once per key and
    reused by every batched call.
    """

    modulus: int
    nbits: int
    num_limbs: int
    n0inv: int  # -modulus^{-1} mod 2^15
    n_limbs: np.ndarray  # [L] uint32
    r2_limbs: np.ndarray  # [L] uint32, R^2 mod modulus
    one_limbs: np.ndarray  # [L] uint32, R mod modulus (Montgomery form of 1)

    @classmethod
    def create(cls, modulus: int, nbits: Optional[int] = None) -> "MontConstants":
        if modulus <= 0 or modulus % 2 == 0:
            raise ValueError("Montgomery modulus must be positive and odd")
        if nbits is None:
            nbits = modulus.bit_length()
        L = limbs_for_bits(nbits)
        R = 1 << (LIMB_BITS * L)
        assert R > 4 * modulus, "GUARD_BITS invariant violated"
        n0inv = (-pow(modulus, -1, 1 << LIMB_BITS)) & LIMB_MASK
        return cls(
            modulus=modulus,
            nbits=nbits,
            num_limbs=L,
            n0inv=n0inv,
            n_limbs=int_to_limbs(modulus, L),
            r2_limbs=int_to_limbs(R * R % modulus, L),
            one_limbs=int_to_limbs(R % modulus, L),
        )

    def as_device_args(self):
        """(n, n0inv, r2, one) as jnp arrays/scalars for the device programs."""
        return (
            jnp.asarray(self.n_limbs),
            _U32(self.n0inv),
            jnp.asarray(self.r2_limbs),
            jnp.asarray(self.one_limbs),
        )


# ---------------------------------------------------------------------------
# Carry handling
# ---------------------------------------------------------------------------


def carry_round(x: jax.Array) -> jax.Array:
    """One redundant carry round: digit_j := (digit_j & M) + (digit_{j-1} >> 15).

    Value-preserving provided the true value fits the limb count (the carry
    out of the top digit must be zero — guaranteed by the callers' bounds).
    Two consecutive rounds bring digits from <= ~2**26 down to <= 2**15
    (inclusive), which is the input precondition of ``mont_mul``.
    """
    lo = x & LIMB_MASK
    hi = x >> LIMB_BITS
    hi_shifted = jnp.concatenate(
        [jnp.zeros_like(hi[..., :1]), hi[..., :-1]], axis=-1
    )
    return lo + hi_shifted


def carry_round2(x: jax.Array) -> jax.Array:
    return carry_round(carry_round(x))


def _carry_prefix(g: jax.Array, p: jax.Array):
    """Inclusive Kogge–Stone prefix of the carry/borrow recurrence
    ``c_out = g | (p & c_in)`` along the last axis.

    g, p: uint32 0/1 generate/propagate flags per limb.  Returns the
    carry OUT of each position (log2(L) levels of elementwise ops — the
    parallel replacement for a per-limb sequential scan)."""

    def comb(a, b):  # left segment 'a', right segment 'b'
        ga, pa = a
        gb, pb = b
        return gb | (pb & ga), pb & pa

    G, _ = jax.lax.associative_scan(comb, (g, p), axis=-1)
    return G


def _shift_in_zero(c: jax.Array) -> jax.Array:
    """[..., L] -> carry INTO each position (prepend 0, drop the last)."""
    return jnp.concatenate(
        [jnp.zeros_like(c[..., :1]), c[..., :-1]], axis=-1
    )


def canonicalize(x: jax.Array) -> jax.Array:
    """Full carry propagation to canonical (< 2**15) limbs.

    Three local carry rounds bring digits from <= 2**32-1 down to
    <= 2**15 (inclusive), leaving only a 0/1 ripple, which a Kogge–Stone
    carry-lookahead resolves in log2(L) levels — no sequential limb scan.
    The final carry out must be zero (value fits the limb count).
    """
    t = carry_round(carry_round(carry_round(x)))  # digits <= 2**15
    g = t >> LIMB_BITS  # in {0, 1}
    r = t & LIMB_MASK
    p = (r == LIMB_MASK).astype(_U32)
    c = _shift_in_zero(_carry_prefix(g, p))
    return (r + c) & LIMB_MASK


def cond_sub_n(x: jax.Array, n: jax.Array) -> jax.Array:
    """If x >= n subtract n, else keep x.  ``x`` must be canonical limbs.

    Implements the single final reduction of "Montgomery without final
    subtraction": values are < 2n on entry and < n on exit.  The borrow
    chain is a Kogge–Stone carry-lookahead (no sequential limb scan).
    """
    n_b = jnp.broadcast_to(n, x.shape)
    g = (x < n_b).astype(_U32)
    p = (x == n_b).astype(_U32)
    B = _carry_prefix(g, p)
    b_in = _shift_in_zero(B)
    diff = (x - n_b - b_in) & LIMB_MASK
    keep = (B[..., -1] == 1)[..., None]
    return jnp.where(keep, x, diff)


# ---------------------------------------------------------------------------
# Montgomery multiplication (redundant-digit CIOS)
# ---------------------------------------------------------------------------


def mont_mul(a: jax.Array, b: jax.Array, n: jax.Array, n0inv: jax.Array) -> jax.Array:
    """Batched Montgomery product  a*b*R^{-1} mod n  (value < 2n).

    a, b: [..., L] uint32 digits <= 2**15 (slightly redundant OK).
    n:    [L] (or broadcastable) canonical limbs of the shared odd modulus.
    n0inv: scalar uint32, -n^{-1} mod 2**15.

    Output digits are <= 2**15 (two carry rounds applied), ready to feed the
    next multiplication.  No conditional subtraction (see module docstring).
    """
    L = a.shape[-1]
    batch_shape = jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    acc = jnp.zeros(batch_shape + (L + 1,), _U32)
    b0 = b[..., 0]

    def body(i, acc):
        ai = jax.lax.dynamic_slice_in_dim(a, i, 1, axis=-1)  # [..., 1]
        t0 = acc[..., 0] + ai[..., 0] * b0
        mi = (t0 * n0inv) & LIMB_MASK
        p1 = ai * b  # [..., L] exact (inputs <= 2**15)
        p2 = mi[..., None] * n  # [..., L]
        lo = (p1 & LIMB_MASK) + (p2 & LIMB_MASK)
        hi = (p1 >> LIMB_BITS) + (p2 >> LIMB_BITS)
        acc = acc.at[..., :L].add(lo)
        acc = acc.at[..., 1:].add(hi)
        carry0 = acc[..., 0] >> LIMB_BITS
        # shift down one digit (divide by 2**15; digit 0 is now 0 mod 2**15)
        acc = jnp.concatenate(
            [acc[..., 1:], jnp.zeros(batch_shape + (1,), _U32)], axis=-1
        )
        acc = acc.at[..., 0].add(carry0)
        return acc

    acc = jax.lax.fori_loop(0, L, body, acc)
    # value < 2n < 2**(15L) => digit L is zero after rounds; drop it.
    return carry_round2(acc)[..., :L]


# ---------------------------------------------------------------------------
# Fixed-window exponentiation
# ---------------------------------------------------------------------------


def _select_pow(table: jax.Array, w: jax.Array) -> jax.Array:
    """Constant-time table lookup: table [T, ..., L], w [...] -> [..., L].

    One-hot multiply-accumulate instead of a gather — static shapes, uniform
    work regardless of the (secret) window value.
    """
    T = table.shape[0]
    ks = jnp.arange(T, dtype=_U32).reshape((T,) + (1,) * w.ndim)
    onehot = (w[None] == ks).astype(_U32)[..., None]  # [T, ..., 1]
    return (table * onehot).sum(axis=0)


def mont_exp(
    base: jax.Array,
    windows: jax.Array,
    n: jax.Array,
    n0inv: jax.Array,
    r2: jax.Array,
    mont_one: jax.Array,
) -> jax.Array:
    """Batched  base^e mod n,  e given as 4-bit windows (MS window first).

    base:    [..., L] canonical limbs, value < n.
    windows: [..., NW] uint32 in [0, 16); broadcasts against base's batch.
    Returns canonical limbs of the fully reduced result (< n).

    Replaces the whole modexp stack of the reference (ipcl/mod_exp.cpp:655-737)
    with one batched, branch-free program: obfuscation, decryption and ct*pt
    all call this with different operand layouts.
    """
    L = base.shape[-1]
    nw = windows.shape[-1]
    windows = windows.astype(_U32)
    batch_shape = jnp.broadcast_shapes(base.shape[:-1], windows.shape[:-1])

    a = mont_mul(base, r2, n, n0inv)  # to Montgomery form, < 2n
    one_b = jnp.broadcast_to(mont_one, batch_shape + (L,))
    # Build the power table at the *base's* batch shape: a shared base (e.g.
    # the DJN hs, ipcl/pub_key.cpp:51-64) gets one table for the whole batch.
    # Left-pad the base's batch dims with 1s so the later one-hot select
    # broadcasts correctly against the full batch shape.
    a = a.reshape((1,) * (len(batch_shape) - (a.ndim - 1)) + a.shape)
    one_t = jnp.broadcast_to(mont_one, a.shape)

    def table_step(prev, _):
        nxt = mont_mul(prev, a, n, n0inv)
        return nxt, nxt

    _, powers = jax.lax.scan(table_step, one_t, None, length=(1 << WINDOW_BITS) - 1)
    table = jnp.concatenate([one_t[None], powers], axis=0)  # [16, *base_batch, L]

    def body(k, acc):
        for _ in range(WINDOW_BITS):
            acc = mont_mul(acc, acc, n, n0inv)
        w = jax.lax.dynamic_slice_in_dim(windows, k, 1, axis=-1)[..., 0]
        w = jnp.broadcast_to(w, batch_shape)
        t = _select_pow(table, w)
        return mont_mul(acc, t, n, n0inv)

    acc = jax.lax.fori_loop(0, nw, body, one_b)

    # leave Montgomery form: multiply by plain 1 (reference analog:
    # ippsMontMul(R, 1) at ipcl/mod_exp.cpp:577-582)
    plain_one = jnp.zeros((L,), _U32).at[0].set(1)
    res = mont_mul(acc, plain_one, n, n0inv)
    res = canonicalize(res)
    return cond_sub_n(res, n)


def mont_mod_mul(
    a: jax.Array, b: jax.Array, n: jax.Array, n0inv: jax.Array, r2: jax.Array
) -> jax.Array:
    """Plain modular product a*b mod n (both operands in ordinary form).

    montmul(montmul(a, r2), b) = (a*R) * b / R = a*b mod n.
    Result canonical and fully reduced (< n).
    The reference analog is BigNumber::ModMul backed by ippsMontMul
    (ipcl/bignum.cpp:321-358), used for obfuscation (ipcl/pub_key.cpp:88-89)
    and homomorphic addition (ipcl/ciphertext.cpp:135-141).
    """
    a_m = mont_mul(a, r2, n, n0inv)
    res = mont_mul(a_m, b, n, n0inv)
    res = canonicalize(res)
    return cond_sub_n(res, n)
