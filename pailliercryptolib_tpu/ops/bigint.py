"""Batched fixed-limb big-integer helper ops (non-modexp paths).

These cover every big-number operation the Paillier scheme layer needs
outside the Montgomery exponentiation core:

* ``mul_shared``    — full product of a shared multiplicand with a batch
                      (reference analog: BigNumber operator* used in
                      raw_encrypt ``n*m+1``, ipcl/pub_key.cpp:99-110, and the
                      CRT recombine ``u*p``, ipcl/pri_key.cpp:148-152).
* ``mul_low``       — low half of the product; with a precomputed Hensel
                      inverse this implements the *exact* division
                      ``L(x) = (x-1)/p`` of the Paillier L-function
                      (reference analog: BigNumber operator/ at
                      ipcl/pri_key.cpp:154-157) without any division at all.
* ``mod_fold``      — ``x mod m`` for a double-width x via one Montgomery
                      multiply of the high half (x_hi * R mod m == x_hi
                      shifted), replacing the reference's per-element
                      ``ciphertext[i] % psq`` loop (ipcl/pri_key.cpp:122-130).
* add / sub helpers with Kogge–Stone carry/borrow lookahead (log-depth
  elementwise ops; used once per scheme op, never inside hot loops).

All arrays are uint32 limb tensors as defined in ops/limbs.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .limbs import LIMB_BITS, LIMB_MASK
from .montgomery import canonicalize, carry_round, cond_sub_n, mont_mul

_U32 = jnp.uint32


def mul_shared(a: jax.Array, x: jax.Array) -> jax.Array:
    """Full product of shared ``a`` [La] with batched ``x`` [..., Lx].

    Returns canonical limbs [..., La+Lx].  ``a`` must be canonical
    (< 2**15); ``x`` digits may be redundant up to 2**15 inclusive.

    The product is ONE exact integer matmul against a Toeplitz matrix of
    a's limbs — out[j] = sum_l x[l] * a[j-l] — evaluated as 7-bit digit
    planes in bf16 with f32 accumulation, the machinery of the RNS base
    extensions (ops/rns.py): each plane product sums <= 127^2 * Lx < 2^24
    (Lx < 1040 limbs), so it is exact, and planes are added only after
    the cast to uint32.  This replaces a fori_loop of La sequential
    dynamic-slice updates whose per-step overhead dominated the decrypt
    tail and the raw-encrypt embedding.
    """
    La = a.shape[-1]
    Lx = x.shape[-1]
    Lo = La + Lx
    # Toeplitz weights T[l, j] = a[j - l] (0 outside [0, La))
    jj = jnp.arange(Lo, dtype=jnp.int32)[None, :]
    ll = jnp.arange(Lx, dtype=jnp.int32)[:, None]
    idx = jj - ll
    valid = (idx >= 0) & (idx < La)
    T = jnp.where(valid, a[jnp.clip(idx, 0, La - 1)], _U32(0))  # [Lx, Lo]

    def planes3(v):  # digits <= 2**15 -> 7/7/2-bit planes, exact in bf16
        bf = jnp.bfloat16
        return (
            (v & _U32(127)).astype(bf),
            ((v >> _U32(7)) & _U32(127)).astype(bf),
            (v >> _U32(14)).astype(bf),
        )

    xp = planes3(x)
    Tp = planes3(T)

    def mm(u, V):
        return jax.lax.dot_general(
            u, V, (((u.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).astype(_U32)

    # group the 9 plane products by total shift s = 7*(i+j)
    S = [None] * 5
    for i in range(3):
        for j in range(3):
            prod = mm(xp[i], Tp[j])
            s = i + j
            S[s] = prod if S[s] is None else S[s] + prod
    # recombine: value = sum_s S_s * 2^(7s), split at limb boundaries
    acc = jnp.zeros(x.shape[:-1] + (Lo,), _U32)

    def shift_cols(arr, by):
        if by == 0:
            return arr
        pad = jnp.zeros(arr.shape[:-1] + (by,), _U32)
        return jnp.concatenate([pad, arr[..., :-by]], axis=-1)

    for s, plane in enumerate(S):
        pshift = 7 * s
        col, r = divmod(pshift, LIMB_BITS)
        lo_part = (plane & _U32((1 << (LIMB_BITS - r)) - 1)) << _U32(r)
        hi_part = plane >> _U32(LIMB_BITS - r)
        acc = acc + shift_cols(lo_part, col) + shift_cols(hi_part, col + 1)
    return canonicalize(acc)


def mul_low(a: jax.Array, x: jax.Array, out_limbs: int) -> jax.Array:
    """Low ``out_limbs`` limbs of a*x, i.e. a*x mod 2**(15*out_limbs).

    ``a`` is shared [La]; ``x`` is batched [..., Lx].  Only used for exact
    Hensel division where the true quotient fits ``out_limbs`` limbs.
    """
    full = mul_shared(a, x[..., :out_limbs])
    return full[..., :out_limbs]


def add_scalar(x: jax.Array, c: int) -> jax.Array:
    """x + c for a small constant c (adds into limb 0, then canonicalizes)."""
    return canonicalize(x.at[..., 0].add(_U32(c)))


def sub_borrow(x: jax.Array, y: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(x - y) mod 2**(15L) with the final borrow flag; canonical inputs.

    Kogge–Stone borrow-lookahead (log-depth), no sequential limb scan."""
    from .montgomery import _carry_prefix, _shift_in_zero

    y_b = jnp.broadcast_to(y, x.shape)
    g = (x < y_b).astype(_U32)
    p = (x == y_b).astype(_U32)
    B = _carry_prefix(g, p)
    b_in = _shift_in_zero(B)
    diff = (x - y_b - b_in) & LIMB_MASK
    return diff, B[..., -1]


def add_carry(x: jax.Array, y: jax.Array) -> jax.Array:
    """x + y, canonical output (carry out of the top limb must be zero)."""
    return canonicalize(x + jnp.broadcast_to(y, x.shape))


def sub_mod(x: jax.Array, y: jax.Array, m: jax.Array) -> jax.Array:
    """(x - y) mod m for canonical x, y < m (shared modulus limbs m)."""
    diff, borrow = sub_borrow(x, y)
    plus_m = canonicalize(diff + m)  # (x - y + m) mod 2^(15L); safe: < 2^(15L)
    return jnp.where((borrow == 1)[..., None], plus_m, diff)


def sub_scalar(x: jax.Array, c: int) -> jax.Array:
    """x - c for small constant 0 <= c < 2**15; x must be >= c."""
    c_l = jnp.zeros((x.shape[-1],), _U32).at[0].set(c)
    diff, _ = sub_borrow(x, c_l)
    return diff


def mod_fold(
    x: jax.Array,
    n: jax.Array,
    n0inv: jax.Array,
    r2: jax.Array,
) -> jax.Array:
    """Reduce double-width ``x`` [..., 2L] to ``x mod m`` represented in
    [..., L] limbs with value < R (not fully reduced — safe as a
    ``mont_exp`` base, whose first to-Montgomery multiply tolerates any
    value < R).

    Uses x = x_hi * 2**(15L) + x_lo and x_hi * 2**(15L) mod m ==
    montmul(x_hi, R^2 mod m), so the whole reduction is one Montgomery
    multiply plus an add — no Barrett constant, no division.
    """
    L = n.shape[-1]
    folded = mont_mul(x[..., L:], r2, n, n0inv)  # x_hi * R mod m
    return mod_fold_combine(folded, x[..., :L], n)


def mod_fold_combine(folded, x_lo, n):
    """Tail of :func:`mod_fold` given folded = x_hi * R mod m (< 2m, digits
    <= 2**15) and the canonical low half x_lo.  Split out so the CRT decrypt
    can vmap the Montgomery product over both residue systems
    (ops/paillier_ops.py)."""
    L = n.shape[-1]
    ext = jnp.concatenate(
        [folded + x_lo, jnp.zeros(folded.shape[:-1] + (1,), _U32)], axis=-1
    )
    ext = canonicalize(ext)  # value < R + 2m, fits L+1 limbs
    n_ext = jnp.concatenate([n, jnp.zeros((1,), _U32)], axis=-1)
    ext = cond_sub_n(ext, n_ext)
    ext = cond_sub_n(ext, n_ext)  # now < R, top limb zero
    return ext[..., :L]
