"""Jitted device pipelines for the Paillier scheme.

Each function is a pure, batched program over uint32 limb tensors; jit
specializations are shared across keys of the same bit size (constants are
traced arguments, not closure captures).  These pipelines replace the
reference's per-op OpenMP loops + modExp dispatch:

* ``encrypt_djn_op`` / ``encrypt_normal_op``  <- ipcl/pub_key.cpp:51-110
* ``decrypt_crt_op``                          <- ipcl/pri_key.cpp:114-152
* ``decrypt_raw_op``                          <- ipcl/pri_key.cpp:92-111
* ``add_ctct_op``                             <- ipcl/ciphertext.cpp:135-141
* ``mul_ctpt_op``                             <- ipcl/ciphertext.cpp:143-162

Two backends share these pipelines: the limb-serial CIOS ops directly
below ("xla", ops/montgomery.py) and the RNS stages further down ("rns",
ops/rns.py, the default).  The CRT decrypt runs both half-width residue
systems as one vmapped program (a leading axis of size 2), the analog of
the reference's two ``mbx_exp_mb8`` batches (SURVEY.md §2.4 item 5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .bigint import (
    mod_fold_combine,
    mul_low,
    mul_shared,
    sub_mod,
    sub_scalar,
)
from .montgomery import (
    canonicalize,
    cond_sub_n,
    mont_exp,
    mont_mod_mul,
    mont_mul,
)

_U32 = jnp.uint32


# ---------------------------------------------------------------------------
# encryption
# ---------------------------------------------------------------------------


def _raw_encrypt(m, n_limbs, L2):
    """ct = n*m + 1 (no reduction needed: m < n  =>  n*m+1 < n^2).

    Exploits g = n+1 exactly as the reference does (ipcl/pub_key.cpp:99-110):
    (n+1)^m = 1 + n*m mod n^2, so plaintext embedding costs one shared-operand
    product instead of a modexp.  ``m`` may arrive narrower than n (callers
    upload only the limbs that cover the widest plaintext in the batch).
    """
    raw = mul_shared(n_limbs, m)  # [B, Ln+Lm]; value < n^2
    pad = L2 - raw.shape[-1]
    if pad > 0:
        raw = jnp.concatenate(
            [raw, jnp.zeros(raw.shape[:-1] + (pad,), _U32)], axis=-1
        )
    else:
        raw = raw[..., :L2]
    # +1 keeps digit 0 <= 2**15: safe redundant input for mont_mul.
    return raw.at[..., 0].add(_U32(1))


@jax.jit
def encrypt_djn_op(m, r_wins, n_limbs, n2_n, n2_n0inv, n2_r2, n2_one, hs):
    """DJN encrypt: ct = (n*m+1) * hs^r mod n^2.

    m:      [B, Ln]  plaintext (already reduced mod n)
    r_wins: [B, NW]  obfuscator exponent windows (randbits = bits/2)
    hs:     [L2]     shared DJN base (table built once, not per element)
    """
    L2 = n2_n.shape[-1]
    raw = _raw_encrypt(m, n_limbs, L2)
    obf = mont_exp(hs, r_wins, n2_n, n2_n0inv, n2_r2, n2_one)
    return mont_mod_mul(raw, obf, n2_n, n2_n0inv, n2_r2)


@jax.jit
def encrypt_normal_op(m, r, n_wins, n_limbs, n2_n, n2_n0inv, n2_r2, n2_one):
    """Normal (non-DJN) encrypt: ct = (n*m+1) * r^n mod n^2.

    r:      [B, L2]  per-element obfuscator bases
    n_wins: [1, NW]  shared exponent n as windows
    """
    L2 = n2_n.shape[-1]
    raw = _raw_encrypt(m, n_limbs, L2)
    obf = mont_exp(r, n_wins, n2_n, n2_n0inv, n2_r2, n2_one)
    return mont_mod_mul(raw, obf, n2_n, n2_n0inv, n2_r2)


@jax.jit
def obfuscate_op(ct, base, wins, n2_n, n2_n0inv, n2_r2, n2_one):
    """Standalone re-obfuscation (ipcl/pub_key.cpp:82-90):
    ct * base^wins mod n^2.  base is the shared DJN hs [L2] with per-row
    windows, or per-row r bases [B, L2] with the shared exponent n."""
    obf = mont_exp(base, wins, n2_n, n2_n0inv, n2_r2, n2_one)
    return mont_mod_mul(ct, obf, n2_n, n2_n0inv, n2_r2)


@jax.jit
def encrypt_noobf_op(m, n_limbs, n2_n):
    """Encrypt without obfuscation (make_secure=false path,
    ipcl/pub_key.cpp:105-107): ct = n*m + 1 exactly."""
    L2 = n2_n.shape[-1]
    return canonicalize(_raw_encrypt(m, n_limbs, L2))


# ---------------------------------------------------------------------------
# decryption
# ---------------------------------------------------------------------------


@jax.jit
def decrypt_crt_op(
    ct,
    sq_n,  # [2, Lp2]   p^2 / q^2 limbs
    sq_n0inv,  # [2]
    sq_r2,  # [2, Lp2]
    sq_one,  # [2, Lp2]
    exp_wins,  # [2, 1, NW]  windows of p-1 / q-1
    hensel,  # [2, Lp]     p^{-1} / q^{-1} mod 2^(15*Lp)
    hfun,  # [2, Lp]     hp / hq
    pq_n,  # [2, Lp]     p / q limbs
    pq_n0inv,  # [2]
    pq_r2,  # [2, Lp]
    pinv_q,  # [Lq]        p^{-1} mod q
    p_limbs,  # [Lp]
):
    """CRT decrypt (ipcl/pri_key.cpp:114-152), both halves in one vmapped
    program:  m_h = L_h(c^{h-1} mod h^2) * hh mod h  for h in {p, q},
    then  m = m_p + ((m_q - m_p) * p^{-1} mod q) * p.
    """
    Lp2 = sq_n.shape[-1]

    # stage 1: fold ct into both residue systems (ct mod p^2 / q^2):
    # x_hi * R mod h^2 via one grouped Montgomery product, then combine.
    two = sq_n.shape[0]
    x_hi = jnp.broadcast_to(ct[None, :, Lp2:], (two,) + ct[:, Lp2:].shape)
    x_lo = jnp.broadcast_to(ct[None, :, :Lp2], (two,) + ct[:, :Lp2].shape)
    folded = jax.vmap(mont_mul)(
        x_hi, jnp.broadcast_to(sq_r2[:, None, :], x_hi.shape), sq_n, sq_n0inv
    )  # [2, B, Lp2]
    bases = jax.vmap(mod_fold_combine, in_axes=(0, 0, 0))(folded, x_lo, sq_n)

    # stage 2: both half-width modexp batches in ONE vmapped program
    res = jax.vmap(mont_exp)(
        bases, exp_wins, sq_n, sq_n0inv, sq_r2, sq_one
    )  # [2, B, Lp2]
    return _crt_tail(res, hensel, hfun, pq_n, pq_n0inv, pq_r2, pinv_q, p_limbs)


def _crt_tail(res, hensel, hfun, pq_n, pq_n0inv, pq_r2, pinv_q, p_limbs):
    """CRT decrypt tail shared by both backends: L-function (Hensel exact
    division) + h multiplier per half, then the CRT recombination
    m = m_p + ((m_q - m_p) * p^{-1} mod q) * p (ipcl/pri_key.cpp:136-152).
    ``res`` [2, B, Lp2]: canonical c^(h-1) mod h^2 for h in {p, q}."""
    Lp = pq_n.shape[-1]

    def lfun(r, hens):
        xm1 = sub_scalar(r, 1)
        return mul_low(hens, xm1, Lp)  # exact (r-1)/h, < h

    ts = jax.vmap(lfun, in_axes=(0, 0))(res, hensel)  # [2, B, Lp]
    dphalves = jax.vmap(mont_mod_mul)(
        ts, jnp.broadcast_to(hfun[:, None, :], ts.shape), pq_n, pq_n0inv, pq_r2
    )  # [2, B, Lp]
    dp, dq = dphalves[0], dphalves[1]
    u = sub_mod(dq, dp, pq_n[1])  # (dq - dp) mod q
    u2 = mont_mod_mul(u, pinv_q, pq_n[1], pq_n0inv[1], pq_r2[1])
    prod = mul_shared(p_limbs, u2)  # [B, Lp+Lq]
    m = prod.at[..., :Lp].add(dp)
    m = canonicalize(m)
    return m[..., : 2 * Lp]


@jax.jit
def decrypt_raw_op(
    ct, lam_wins, n2_n, n2_n0inv, n2_r2, n2_one, hensel_n, x_limbs, n_n, n_n0inv,
    n_r2,
):
    """RAW decrypt (ipcl/pri_key.cpp:92-111):
    m = L(c^lambda mod n^2) * x mod n, L(y) = (y-1)/n via Hensel division."""
    res = mont_exp(ct, lam_wins, n2_n, n2_n0inv, n2_r2, n2_one)
    return _hensel_post(res, hensel_n, x_limbs, n_n, n_n0inv, n_r2)


def _hensel_post(res, hensel_n, x_limbs, n_n, n_n0inv, n_r2):
    """L-function + x multiplier tail of RAW decryption."""
    Ln = n_n.shape[-1]
    xm1 = sub_scalar(res, 1)
    t = mul_low(hensel_n, xm1, Ln)  # (res-1)/n < n
    return mont_mod_mul(t, x_limbs, n_n, n_n0inv, n_r2)


# ---------------------------------------------------------------------------
# homomorphic ops
# ---------------------------------------------------------------------------


@jax.jit
def add_ctct_op(a, b, n2_n, n2_n0inv, n2_r2):
    """CT+CT: elementwise a*b mod n^2 (ipcl/ciphertext.cpp:135-141)."""
    return mont_mod_mul(a, b, n2_n, n2_n0inv, n2_r2)


@jax.jit
def mul_ctpt_op(ct, pt_wins, n2_n, n2_n0inv, n2_r2, n2_one):
    """CT*PT: ct^pt mod n^2 (ipcl/ciphertext.cpp:143-162)."""
    return mont_exp(ct, pt_wins, n2_n, n2_n0inv, n2_r2, n2_one)


# ---------------------------------------------------------------------------
# RNS pipelines — the default backend for every modexp-bearing operation.
#
# Same scheme semantics as the ops above, but the exponentiation runs in the
# residue number system (ops/rns.py): base extensions are exact digit-plane
# matmuls.  Conversions limbs<->RNS are loop-free matmuls; the p-width
# decrypt tails reuse the CIOS products (a few multiplies per row).
# ---------------------------------------------------------------------------

from .rns import (  # noqa: E402
    fb_table_planes,
    limbs_to_rns,
    rns_fb_exp,
    rns_mont_exp,
    rns_mont_mul,
    rns_to_limbs,
)


def _rns_finalize(res, conv, n_limbs, out_limbs):
    """RNS residues of a value <= 2N -> canonical fully-reduced limbs."""
    limbs = rns_to_limbs(res, conv)  # [B, Lout], canonical, value <= 2N
    Lout = limbs.shape[-1]
    pad = jnp.zeros((Lout - n_limbs.shape[-1],), _U32)
    n_ext = jnp.concatenate([n_limbs, pad], axis=-1)
    limbs = cond_sub_n(cond_sub_n(limbs, n_ext), n_ext)
    return limbs[..., :out_limbs]


def _rns_modexp(base, wins, conv):
    return rns_mont_exp(limbs_to_rns(base, conv), wins, conv)


@jax.jit
def decrypt_crt_rns_op(
    ct,
    sq_n,  # [2, Lp2]   p^2 / q^2 limbs (finalize conditional subtracts)
    exp_wins,  # [2, 1, NW]
    hensel, hfun,
    pq_n, pq_n0inv, pq_r2,
    pinv_q, p_limbs,
    conv2,  # [2, ...] stacked device_consts of the p^2 / q^2 contexts
):
    """CRT decrypt with both half-width RNS modexps vmapped over the G=2
    (p^2, q^2) group.

    The modexp consumes the FULL n^2-width ciphertext: each group's Cin
    weights are (2^(15 l) mod h^2) mod m (ops/rns.py RNSContext.Cin), so
    the reference's per-element "ct mod p^2 / q^2" loop
    (ipcl/pri_key.cpp:122-130) IS the input-conversion matmul."""
    Lp2 = sq_n.shape[-1]
    res_rns = jax.vmap(_rns_modexp, in_axes=(None, 0, 0))(ct, exp_wins, conv2)
    res = jax.vmap(_rns_finalize, in_axes=(0, 0, 0, None))(
        res_rns, conv2, sq_n, Lp2
    )  # [2, B, Lp2] canonical < h^2
    return _crt_tail(res, hensel, hfun, pq_n, pq_n0inv, pq_r2, pinv_q, p_limbs)


@jax.jit
def rns_modexp_stage(base, wins, conv):
    """RNS modexp: limbs [B, L] -> residues [B, K] of a value < 2N.
    ``wins`` is [B, NW] (per-row exponents) or [1, NW] (one shared)."""
    return _rns_modexp(base, wins, conv)


@jax.jit
def fb_table_stage(g_limbs, conv):
    """Build the fixed-base table planes [NP, 256, 2K] (bf16) from g_limbs
    [NP, L]: canonical limbs of g_i = base^(2^(8 i)) mod N (host-computed
    square chain)."""
    return fb_table_planes(limbs_to_rns(g_limbs, conv), conv)


@functools.partial(jax.jit, static_argnames=("mont_out",))
def rns_fb_modexp_stage(planes, win_bytes, conv, mont_out=False):
    """Fixed-base modexp: exponent bytes [B, NP] (LS first) -> residues
    [B, K] of a representative <= 2N of base^e mod N (or of
    base^e * M_A < 3N when ``mont_out`` — see rns.rns_fb_exp)."""
    return rns_fb_exp(planes, win_bytes, conv, mont_out=mont_out)


@functools.partial(jax.jit, static_argnames=("out_limbs",))
def rns_finalize_stage(res, conv, n_limbs, out_limbs):
    return _rns_finalize(res, conv, n_limbs, out_limbs)


def _encrypt_post(res, m_a, n_limbs, conv, n2_n, res_mont):
    """The shared encrypt tail: plaintext embedding (n*m+1) and the
    obfuscation multiply, entirely in RNS.  With ``res_mont`` the modexp
    left the obfuscator in Montgomery form (mont_out), so the obfuscation
    multiply doubles as the leave-Montgomery multiply: ONE product."""
    L2 = n2_n.shape[-1]
    raw = _raw_encrypt(m_a, n_limbs, L2)  # < n^2 = N, digits <= 2^15
    return _mul_res_post(raw, res, conv, n2_n, res_mont)


@functools.partial(jax.jit, static_argnames=("res_mont",))
def encrypt_post_stage(res, m_a, n_limbs, conv, n2_n, res_mont=False):
    """Encrypt tail in ONE dispatch (see _encrypt_post): the obfuscator
    arrives as residues from the modexp, so the obfuscation multiply runs
    in residue space."""
    return _encrypt_post(res, m_a, n_limbs, conv, n2_n, res_mont)


def _rotl(x, r):
    return (x << _U32(r)) | (x >> _U32(32 - r))


def _chacha20_blocks(key8, nonce3, nblocks):
    """RFC 8439 ChaCha20 keystream: ``nblocks`` 64-byte blocks as a
    [nblocks, 64] uint8 array (counter starts at 0).

    A vetted CSPRNG construction — NOT jax.random (whose generators are
    documented as non-cryptographic).  The 16-word state lives as 16
    [nblocks] u32 vectors, so every quarter-round is elementwise across
    blocks (add-rotate-xor ops that XLA fuses); only the counter word
    differs per block.  Validated against the RFC 8439
    §2.3.2 test vector (tests/test_rns_backend.py)."""
    consts = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
    ctr = jnp.arange(nblocks, dtype=_U32)
    ones = jnp.ones((nblocks,), _U32)

    def bcast(w):
        return ones * w

    init = (
        [bcast(_U32(c)) for c in consts]
        + [bcast(key8[i]) for i in range(8)]
        + [ctr]
        + [bcast(nonce3[i]) for i in range(3)]
    )
    x = list(init)

    def qr(a, b, c, d):
        a = a + b
        d = _rotl(d ^ a, 16)
        c = c + d
        b = _rotl(b ^ c, 12)
        a = a + b
        d = _rotl(d ^ a, 8)
        c = c + d
        b = _rotl(b ^ c, 7)
        return a, b, c, d

    for _ in range(10):  # 10 double-rounds = 20 rounds
        x[0], x[4], x[8], x[12] = qr(x[0], x[4], x[8], x[12])
        x[1], x[5], x[9], x[13] = qr(x[1], x[5], x[9], x[13])
        x[2], x[6], x[10], x[14] = qr(x[2], x[6], x[10], x[14])
        x[3], x[7], x[11], x[15] = qr(x[3], x[7], x[11], x[15])
        x[0], x[5], x[10], x[15] = qr(x[0], x[5], x[10], x[15])
        x[1], x[6], x[11], x[12] = qr(x[1], x[6], x[11], x[12])
        x[2], x[7], x[8], x[13] = qr(x[2], x[7], x[8], x[13])
        x[3], x[4], x[9], x[14] = qr(x[3], x[4], x[9], x[14])

    words = jnp.stack(
        [xi + ii for xi, ii in zip(x, init)], axis=1
    )  # [nblocks, 16], little-endian word order
    by = jnp.stack(
        [
            (words >> _U32(8 * i)).astype(jnp.uint8)
            for i in range(4)
        ],
        axis=-1,
    )  # [nblocks, 16, 4]
    return by.reshape(nblocks, 64)


def _device_obf_bytes(seed, mask, B):
    """Expand a per-call OS-CSPRNG seed into [B, NP] obfuscator exponent
    bytes with an on-device ChaCha20 keystream (RFC 8439) — a
    cryptographic DRBG in the reference's seeded-DRBG role
    (ipcl/utils/common.cpp:52-77), evaluated on the device so the host
    uploads 44 bytes instead of the full exponent matrix.

    ``seed``: [S, 11] uint32 rows of (256-bit key, 96-bit nonce)
    (utils/rng.DeviceSeed); row 0 keys this expansion — under a sharded
    mesh each device's shard carries its OWN row, so shards draw
    independent keystreams.  ``mask`` [NP] uint8 zeroes bytes beyond
    randbits and trims the top byte when randbits % 8 != 0."""
    NP = mask.shape[-1]
    return _chacha_bytes(seed, B, NP) & mask[None, :]


def _chacha_bytes(seed, B, nbytes):
    """[B, nbytes] uint8 from the ChaCha20 keystream keyed by seed row 0."""
    total = B * nbytes
    ks = _chacha20_blocks(seed[0, :8], seed[0, 8:11], -(-total // 64))
    return ks.reshape(-1)[:total].reshape(B, nbytes)


@jax.jit
def encrypt_fb_fused_rng_stage(planes, seed, mask, m_a, n_limbs, conv, n2_n):
    """encrypt_fb_fused_stage with the obfuscator exponents generated ON
    DEVICE from a 44-byte seed row (utils/rng.DeviceSeed): the host
    uploads the seed instead of the [B, NP] exponent byte matrix."""
    wb = _device_obf_bytes(seed, mask, m_a.shape[0])
    return encrypt_fb_fused_stage(planes, wb, m_a, n_limbs, conv, n2_n)


def _bytes_to_limbs_dev(by, L):
    """[B, nbytes] uint8 -> [B, L] canonical 15-bit limbs on device.

    Every 15 bytes hold exactly 8 limbs, so limb 8g+j of byte group g is
    read from the group's static byte offsets (15j)//8 .. +2 with shift
    (15j)%8 — static slices, no gather."""
    B, nbytes = by.shape
    G = -(-L // 8)  # 15 * G bytes >= 15 * L bits cover every limb
    by = jnp.pad(by[:, : 15 * G], ((0, 0), (0, 15 * G - min(nbytes, 15 * G))))
    grp = by.astype(_U32).reshape(B, G, 15)
    grp = jnp.pad(grp, ((0, 0), (0, 0), (0, 1)))  # limb 7 reads byte 15
    limbs = []
    for j in range(8):
        o, sh = divmod(15 * j, 8)
        word = grp[..., o] | (grp[..., o + 1] << 8) | (grp[..., o + 2] << 16)
        limbs.append((word >> sh) & _U32((1 << 15) - 1))
    return jnp.stack(limbs, axis=-1).reshape(B, 8 * G)[:, :L]


@functools.partial(jax.jit, static_argnames=("ebits",))
def encrypt_normal_rng_stage(seed, m_a, n_wins, n_limbs, conv, n2_n, ebits):
    """Normal-mode (non-DJN) encrypt in ONE jitted program with the
    obfuscator base generated ON DEVICE: ct = (n*m+1) * r^n mod n^2
    (ipcl/pub_key.cpp:66-80,99-110).

    The base is an UNREDUCED uniform r'' of ``ebits`` = 2*|n|+3 bits
    from the ChaCha20 keystream: (r + k*n)^n ≡ r^n (mod n^2) for any k
    (the j>=1 binomial terms carry n^2), so r'' acts exactly as
    r'' mod n drawn uniformly (bias ~2^-(|n|+3)) — no modular reduction
    and no ~2 MB host upload of base limbs.  r'' < 2^(2|n|+3) < M_A/2
    (the quantized target gives M_A >= 2^(2|n|+4)), so the modexp's
    first to-Montgomery multiply absorbs it: out < N/2 + 2N < 3N."""
    B = m_a.shape[0]
    L2 = n2_n.shape[-1]
    nbytes = -(-ebits // 8)
    by = _chacha_bytes(seed, B, nbytes)
    top = ebits % 8
    if top:
        mask = np.full((nbytes,), 0xFF, np.uint8)
        mask[-1] = (1 << top) - 1
        by = by & jnp.asarray(mask)[None, :]
    r_a = _bytes_to_limbs_dev(by, L2)
    res = _rns_modexp(r_a, n_wins, conv)
    return _encrypt_post(res, m_a, n_limbs, conv, n2_n, res_mont=False)


@jax.jit
def obfuscate_fb_fused_rng_stage(planes, seed, mask, ct, conv, n2_n):
    """apply_obfuscator in ONE jitted program: on-device exponent
    expansion + fixed-base modexp (mont_out) + the obfuscation multiply
    + finalize (the encrypt_fb_fused_rng_stage twin for existing
    ciphertexts, ipcl/pub_key.cpp:82-90)."""
    wb = _device_obf_bytes(seed, mask, ct.shape[0])
    res = rns_fb_exp(planes, wb, conv, mont_out=True)
    return _mul_res_post(ct, res, conv, n2_n, res_mont=True)


@jax.jit
def encrypt_fb_fused_stage(planes, win_bytes, m_a, n_limbs, conv, n2_n):
    """DJN encrypt in ONE jitted program: fixed-base modexp (mont_out) +
    plaintext embedding + obfuscation multiply + finalize."""
    res = rns_fb_exp(planes, win_bytes, conv, mont_out=True)
    return _encrypt_post(res, m_a, n_limbs, conv, n2_n, res_mont=True)


@functools.partial(jax.jit, static_argnames=("res_mont",))
def mul_res_post_stage(ct, res, conv, n2_n, res_mont=False):
    """ct (limbs) * res (RNS residues straight from a modexp) mod n^2 —
    the obfuscation multiply with the limb->RNS conversion of the second
    operand already paid (used by apply_obfuscator).  ``res_mont`` as in
    encrypt_post_stage."""
    return _mul_res_post(ct, res, conv, n2_n, res_mont)


def _mul_res_post(ct, res, conv, n2_n, res_mont):
    L2 = n2_n.shape[-1]
    ra = limbs_to_rns(ct, conv)
    if res_mont:
        out = rns_mont_mul(ra, res, conv)  # ct*obf, value < 3N
    else:
        t = rns_mont_mul(ra, conv["mont_sq"][None, :], conv)  # ct*MA
        out = rns_mont_mul(t, res, conv)  # ct*obf, value < 3N
    return _rns_finalize(out, conv, n2_n, L2)


@jax.jit
def add_ctct_rns_op(a, b, conv, n2_n):
    """CT+CT = a*b mod n^2 in RNS: two exact conversions + two Montgomery
    products.  Broadcast semantics handled by callers."""
    return _mul_res_post(a, limbs_to_rns(b, conv), conv, n2_n, res_mont=False)


@jax.jit
def hensel_post_stage(res, hensel_n, x_limbs, n_n, n_n0inv, n_r2):
    """L-function + x multiplier tail of RAW decryption."""
    return _hensel_post(res, hensel_n, x_limbs, n_n, n_n0inv, n_r2)


# ---------------------------------------------------------------------------
# packed-transfer helpers (two 15-bit limbs per uint32 on the wire)
# ---------------------------------------------------------------------------


@jax.jit
def pack_out_op(x):
    """[B, L] canonical limbs -> [B, ceil(L/2)] packed words (device side)."""
    L = x.shape[-1]
    if L % 2:
        x = jnp.concatenate([x, jnp.zeros(x.shape[:-1] + (1,), _U32)], -1)
    return x[..., 0::2] | (x[..., 1::2] << jnp.uint32(15))


@functools.partial(jax.jit, static_argnames=("num_limbs",))
def unpack_in_op(packed, num_limbs):
    """Inverse of pack_out_op (device side)."""
    lo = packed & jnp.uint32(0x7FFF)
    hi = packed >> jnp.uint32(15)
    out = jnp.stack([lo, hi], axis=-1).reshape(
        packed.shape[:-1] + (2 * packed.shape[-1],)
    )
    return out[..., :num_limbs]
