"""RNS (residue number system) Montgomery modular exponentiation.

This is the library's modexp backend on every platform.  A limb-serial
CIOS multiply (ops/montgomery.py) is ~15*L^2 dependent integer ops per
modular multiply; this module reformulates the same batched modexp so that
most of the arithmetic becomes batch-shared [B, k] @ [k, k+1] matrix
products per modular multiply — exact integer matmuls over 7-bit digit
planes (bf16 operands, f32 accumulation), which XLA hands to the matrix
units — plus elementwise Barrett chains that XLA fuses.  It takes the
place of the reference's acceleration stack (AVX512-IFMA lanes + QAT
offload, ipcl/mod_exp.cpp) behind the same dispatch seam.

Algorithm: Bajard–Imbert RNS Montgomery multiplication.

* A value x < 3N is represented by its residues modulo two bases of 14-bit
  primes, A = {a_1..a_k} and B = {b_1..b_k}, plus one redundant modulus m_r:
  a [batch, 2k+1] uint32 tensor.  M_A = prod(a_i) >= 9N, M_B >= 9N.
* MM(x, y) = x*y*M_A^{-1} mod N (up to a < 3N representative):
    1. s = x*y               (elementwise per residue)
    2. q = s * (-N^{-1})     (base A only, elementwise)
    3. q -> base B + m_r     (MATMUL: sigma_i = q_i * (M_A/a_i)^{-1} mod a_i,
                              q_hat_j = sum_i sigma_i * ((M_A/a_i) mod b_j)
                              - alpha_hat * M_A; Kawamura's float estimate for
                              alpha_hat may undershoot by 1, giving
                              q_hat = q + delta*M_A, delta in {0,1} — absorbed
                              by the < 3N invariant)
    4. r = (s + q_hat*N) * M_A^{-1}   (base B + m_r, elementwise; exact)
    5. r -> base A           (MATMUL, *exact* Shenoy–Kumaresan extension:
                              alpha' recovered exactly via the redundant
                              residue r mod m_r)
* Exactness of the matmuls: operands are split into 7-bit digits (integers
  <= 127 are exact in bf16); each digit-plane product accumulates <= 127^2
  over <= k+1 terms in f32.  At the widest supported context (4096-bit
  keys' n^2, k = 637) that is 127^2 * 638 < 2^23.3 < 2^24, so every plane
  sum is an exact f32 integer.  Two planes are never added in f32 (their
  sum can reach 2^24.3): each is cast to uint32 first.
* All per-residue reductions use a 32-bit-safe Barrett: for v < 2^30,
  q_est = ((v >> 14) * floor(2^28/m)) >> 14, r = v - q_est*m, then up to
  three conditional subtracts.  No 64-bit arithmetic anywhere.
* Secret exponents (obfuscator bytes, p-1/q-1, lambda) never index memory:
  window-table entries are selected with one-hot products (rns_mont_exp's
  masked sum, rns_fb_exp's one-hot matmul), so the work and the addresses
  touched are the same for every exponent.

The whole scheme is validated limb-for-limb against Python pow() in
tests/test_rns.py.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .limbs import LIMB_BITS, WINDOW_BITS, int_to_limbs

_U32 = jnp.uint32
_F32 = jnp.float32
_BF16 = jnp.bfloat16

MOD_BITS = 14  # moduli are primes < 2^14 (pool spans (2^12, 2^14))
DIGIT_BITS = 7  # matmul operands split into 7-bit digits (exact in bf16)
DIGIT_MASK = (1 << DIGIT_BITS) - 1
GUARD_FACTOR = 9  # M_A, M_B >= GUARD_FACTOR * N  (supports the < 3N invariant)
ALPHA_MARGIN = 1.0 / 16.0  # Kawamura floor-estimate safety offset

#: Pool floor.  create() allocates largest-first, so a context only
#: reaches below 2^13 for very wide moduli (>= ~5.9k bits — 3072/4096-bit
#: keys' n^2; the reference's own QAT envelope reaches 8192-bit operands,
#: module/heqat/include/heqat/bnops.h:16-20).  Such "wide-pool" contexts
#: REQUIRE the f32-reciprocal reduction (is_wide_pool /
#: barrett_reduce): the integer-Barrett quotient-error bound
#: v/2^28 + 2^14/m + 2 outgrows the 4m/2m/m conditional-subtract chain
#: once m < 2^13, while the f32 flavor's {0,1} error holds for any
#: m > 2^12.
POOL_MIN_BITS = 12


def _sieve_primes(lo: int, hi: int):
    sieve = np.ones(hi, dtype=bool)
    sieve[:2] = False
    for p in range(2, int(hi**0.5) + 1):
        if sieve[p]:
            sieve[p * p :: p] = False
    return [int(p) for p in np.nonzero(sieve)[0] if p >= lo]


@functools.lru_cache(maxsize=None)
def _prime_pool():
    return _sieve_primes((1 << POOL_MIN_BITS) + 1, 1 << MOD_BITS)


def is_wide_pool(ctx: "RNSContext") -> bool:
    """Whether ``ctx`` allocated any modulus below 2^13 (see POOL_MIN_BITS:
    these contexts must run the f32-reciprocal reduction flavor)."""
    return int(ctx.mods.min()) < (1 << 13)


def _barrett_consts(ms: np.ndarray) -> np.ndarray:
    """floor(2^28 / m) for each modulus (fits 16 bits)."""
    return (np.uint64(1 << 28) // ms.astype(np.uint64)).astype(np.uint32)


def inv_f32(mods: np.ndarray) -> np.ndarray:
    """f32 reciprocal reduction constants (1 - 2^-20)/m: the truncated
    quotient q = i32(f32(v) * mu) is in {q_true-1, q_true} for v < 2^31
    and any m > 2^12 (the 2^-20 downward bias dominates the rounding
    errors), so ONE conditional subtract canonicalizes."""
    return ((1.0 - 2.0**-20) / np.asarray(mods, np.float64)).astype(
        np.float32
    )


def _alloc_bases(nbits: int, product_bits: Optional[int] = None):
    """Greedy largest-first base allocation: (M_A, A, M_B, B, m_r).

    The ONE allocator behind both :meth:`RNSContext.create` and the
    width gate (:func:`rns_supported`), so the two cannot drift.  The
    base-product target is QUANTIZED to a 16-bit grid: with the raw
    target 9*N, the moduli count k — and with it every program shape and
    persistent-compile-cache key — would flip at prime-count boundaries
    depending on the key's exact magnitude, so two same-bit-size keys
    could compile distinct (but identical-cost) programs and never
    share the cache across processes.  Rounding ceil(log2(9N)) <=
    nbits+4 up to a multiple of 16 makes k a function of the key's size
    class only, at a cost of at most one extra modulus.  Raises
    ValueError when the pool cannot serve the width."""
    pool = sorted(_prime_pool(), reverse=True)
    tbits = -(-(nbits + GUARD_FACTOR.bit_length()) // 16) * 16
    target = 1 << tbits
    if product_bits is not None:
        target = max(target, 1 << product_bits)

    def take(start):
        prod, chosen, i = 1, [], start
        while prod < target:
            if i >= len(pool):
                raise ValueError("prime pool exhausted; modulus too large")
            prod *= pool[i]
            chosen.append(pool[i])
            i += 1
        return prod, chosen, i

    MA, A, i1 = take(0)
    MB, Bb, i2 = take(i1)
    # pad the smaller base so both have k moduli (+1 prime for m_r)
    if i2 + abs(len(A) - len(Bb)) >= len(pool):
        raise ValueError("prime pool exhausted; modulus too large")
    while len(A) < len(Bb):
        MA *= pool[i2]
        A.append(pool[i2])
        i2 += 1
    while len(Bb) < len(A):
        MB *= pool[i2]
        Bb.append(pool[i2])
        i2 += 1
    mr = pool[i2]
    if len(A) >= mr:
        raise ValueError("alpha' must fit the redundant modulus")
    return MA, A, MB, Bb, mr


def _pool_can_serve(nbits: int) -> bool:
    """Whether :meth:`RNSContext.create` would succeed for an ``nbits``
    modulus (runs the exact shared allocator)."""
    try:
        _alloc_bases(nbits)
        return True
    except ValueError:
        return False


@functools.lru_cache(maxsize=None)
def rns_max_modulus_bits() -> int:
    """Largest modulus bit-width the prime pool can serve.

    Found by bisection over :func:`_pool_can_serve` (the exact
    simulation of create()'s allocator).  Above this the engines fall
    back to the width-generic CIOS backend ("xla", ops/montgomery.py)."""
    lo, hi = 16, 1 << 16
    while lo < hi:  # invariant: serve(lo) true, serve(hi) false
        mid = (lo + hi + 1) // 2
        if _pool_can_serve(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def rns_supported(nbits: int) -> bool:
    """Whether the RNS backend can represent an ``nbits`` modulus."""
    return nbits <= rns_max_modulus_bits()


@dataclass(frozen=True)
class RNSContext:
    """Host-side constants for RNS Montgomery arithmetic modulo N."""

    N: int
    k: int  # moduli per base
    K: int  # total residues = 2k + 1
    MA: int
    MB: int
    mr: int
    # device constant arrays (numpy; engines wrap with jnp.asarray)
    mods: np.ndarray  # [K] all moduli: A | B | m_r
    barrett: np.ndarray  # [K] floor(2^28/m)
    neg_Ninv_A: np.ndarray  # [k]   -N^{-1} mod a_i
    MAi_inv_A: np.ndarray  # [k]   (M_A/a_i)^{-1} mod a_i
    sigma_c_A: np.ndarray  # [k]   (-N^{-1} * (M_A/a_i)^{-1}) mod a_i (fused)
    T1ext: np.ndarray  # [k+1, k+1] T1 plus a last row of (-M_A) mod (b_j|m_r)
    inv_a_f32: np.ndarray  # [k]   1/a_i as f32 (Kawamura)
    T1: np.ndarray  # [k, k+1]  (M_A/a_i) mod (b_j | m_r)
    MA_mod_B: np.ndarray  # [k+1] M_A mod (b_j | m_r)
    N_B: np.ndarray  # [k+1] N mod (b_j | m_r)
    MAinv_B: np.ndarray  # [k+1] M_A^{-1} mod (b_j | m_r)
    MBj_inv_B: np.ndarray  # [k]   (M_B/b_j)^{-1} mod b_j
    T2: np.ndarray  # [k, k]  (M_B/b_j) mod a_i
    T2r: np.ndarray  # [k]    (M_B/b_j) mod m_r
    MBinv_mr: int  # M_B^{-1} mod m_r
    MB_mod_A: np.ndarray  # [k]   M_B mod a_i
    # conversions
    Cin: np.ndarray  # [L, K] 2^(15*l) mod m  (standard limbs -> residues)
    Aout_limbs: np.ndarray  # [k, Lout] limbs of M_A/a_i (RNS -> integer)
    MA_limbs: np.ndarray  # [Lout] limbs of M_A
    Lin: int
    Lout: int
    # Montgomery domain constants, as residue vectors [K]
    mont_sq: np.ndarray  # M_A^2 mod N
    mont_one: np.ndarray  # M_A mod N
    plain_one: np.ndarray  # 1

    @classmethod
    def create(
        cls,
        N: int,
        in_limbs: Optional[int] = None,
        product_bits: Optional[int] = None,
    ) -> "RNSContext":
        """``product_bits`` forces the base product above 2**product_bits so
        two same-size moduli (CRT's p^2 and q^2) get identical prime bases
        and hence stackable constants for the vmapped (G=2) CRT modexp."""
        if N <= 0 or N % 2 == 0:
            raise ValueError("RNS modulus must be positive and odd")
        nbits = N.bit_length()
        # the ONE shared allocator (also behind rns_supported's gate):
        # greedy largest-first with the quantized target — see there
        MA, A, MB, Bb, mr = _alloc_bases(nbits, product_bits)
        k = len(A)
        assert k == len(Bb)

        A_np = np.array(A, np.uint32)
        B_np = np.array(Bb, np.uint32)
        Bx = Bb + [mr]  # extension targets of base A
        Bx_np = np.array(Bx, np.uint32)

        MAi = [MA // a for a in A]
        MBj = [MB // b for b in Bb]

        Lin = in_limbs if in_limbs is not None else -(-nbits // LIMB_BITS)
        Lout = -(-(MA.bit_length() + k.bit_length() + 1) // LIMB_BITS) + 1

        mods = np.concatenate([A_np, B_np, np.array([mr], np.uint32)])
        ctx = cls(
            N=N,
            k=k,
            K=2 * k + 1,
            MA=MA,
            MB=MB,
            mr=mr,
            mods=mods,
            barrett=_barrett_consts(mods),
            neg_Ninv_A=np.array([(-pow(N, -1, a)) % a for a in A], np.uint32),
            MAi_inv_A=np.array(
                [pow(MAi[i] % A[i], -1, A[i]) for i in range(k)], np.uint32
            ),
            sigma_c_A=np.array(
                [
                    (-pow(N, -1, a) * pow(MAi[i] % a, -1, a)) % a
                    for i, a in enumerate(A)
                ],
                np.uint32,
            ),
            T1ext=np.array(
                [[MAi[i] % m for m in Bx] for i in range(k)]
                + [[(-MA) % m for m in Bx]],
                np.uint32,
            ),
            inv_a_f32=(1.0 / A_np.astype(np.float64)).astype(np.float32),
            T1=np.array(
                [[MAi[i] % m for m in Bx] for i in range(k)], np.uint32
            ),
            MA_mod_B=np.array([MA % m for m in Bx], np.uint32),
            N_B=np.array([N % m for m in Bx], np.uint32),
            MAinv_B=np.array([pow(MA % m, -1, m) for m in Bx], np.uint32),
            MBj_inv_B=np.array(
                [pow(MBj[j] % Bb[j], -1, Bb[j]) for j in range(k)], np.uint32
            ),
            T2=np.array([[MBj[j] % a for a in A] for j in range(k)], np.uint32),
            T2r=np.array([MBj[j] % mr for j in range(k)], np.uint32),
            MBinv_mr=int(pow(MB % mr, -1, mr)),
            MB_mod_A=np.array([MB % a for a in A], np.uint32),
            # Limb weights are taken mod N first: row l converts limb l
            # with weight (2^(15 l) mod N) mod m.  For limbs below N's
            # width this equals 2^(15 l) mod m exactly; rows ABOVE N's
            # width implicitly reduce the represented value mod N, so a
            # caller may feed limbs WIDER than N (e.g. CRT decrypt feeds
            # the full n^2-width ciphertext into the p^2/q^2 systems and
            # the "ct mod p^2" fold happens inside this one conversion
            # matmul).  The represented value V satisfies V ≡ x (mod N),
            # V <= x, and V < Lin * 2^15 * N — create() callers size
            # product_bits so M_A comfortably exceeds that bound.
            Cin=np.array(
                [
                    [pow(2, LIMB_BITS * l, N) % int(m) for m in mods]
                    for l in range(Lin)
                ],
                np.uint32,
            ),
            Aout_limbs=np.stack(
                [int_to_limbs(MAi[i], Lout) for i in range(k)]
            ),
            MA_limbs=int_to_limbs(MA, Lout),
            Lin=Lin,
            Lout=Lout,
            mont_sq=cls._to_residues(MA * MA % N, mods),
            mont_one=cls._to_residues(MA % N, mods),
            plain_one=cls._to_residues(1, mods),
        )
        return ctx

    @staticmethod
    def _to_residues(x: int, mods: np.ndarray) -> np.ndarray:
        return np.array([x % int(m) for m in mods], np.uint32)

    def to_residues(self, x: int) -> np.ndarray:
        return self._to_residues(x, self.mods)

    def host_consts(self) -> dict:
        """All constants the device stages read, as numpy arrays.

        Wide-pool contexts (any modulus < 2^13) ship the f32-reciprocal
        reduction constants instead of integer Barrett — barrett_reduce
        dispatches on the dtype (see there for the bound argument)."""
        names = (
            "mods neg_Ninv_A MAi_inv_A inv_a_f32 T1 sigma_c_A T1ext MA_mod_B "
            "N_B MAinv_B MBj_inv_B T2 T2r MB_mod_A Cin Aout_limbs MA_limbs "
            "mont_sq mont_one plain_one"
        ).split()
        out = {name: getattr(self, name) for name in names}
        out["barrett"] = (
            inv_f32(self.mods) if is_wide_pool(self) else self.barrett
        )
        out["MBinv_mr"] = np.uint32(self.MBinv_mr)
        return out

    def device_consts(self) -> dict:
        """:meth:`host_consts` as jnp arrays (shared across calls via jit
        args)."""
        return {k: jnp.asarray(v) for k, v in self.host_consts().items()}


# ---------------------------------------------------------------------------
# stage primitives (work on jnp values)
# ---------------------------------------------------------------------------


def barrett_reduce(v, m, mu):
    """v mod m, dispatched on ``mu``'s dtype (device_consts picks it):

    * uint32 ``mu`` = floor(2^28/m): integer Barrett for v < 2^30 and
      m in (2^13, 2^14).  Quotient error < v/2^28 + 2^14/m + 1 < 7, so
      the 4m/2m/m conditional-subtract chain canonicalizes; all
      intermediates fit uint32.
    * float32 ``mu`` = (1 - 2^-20)/m (:func:`inv_f32`): reciprocal
      flavor for wide-pool contexts (m down to 2^12, where the integer
      bound outgrows any 3-subtract chain) — valid for v < 2^31 with
      ONE conditional subtract.
    """
    if mu.dtype == _F32:
        q = (v.astype(jnp.int32).astype(_F32) * mu).astype(jnp.int32)
        r = v - q.astype(_U32) * m
        return jnp.where(r >= m, r - m, r)
    q = ((v >> MOD_BITS) * mu) >> MOD_BITS
    r = v - q * m
    r = jnp.where(r >= 4 * m, r - 4 * m, r)
    r = jnp.where(r >= 2 * m, r - 2 * m, r)
    r = jnp.where(r >= m, r - m, r)
    return r


def mulmod(x, y, m, mu):
    """(x*y) mod m for x, y < 2^14 (product < 2^28, exact in uint32)."""
    return barrett_reduce(x * y, m, mu)


def _digit_split(x):
    """uint32 (< 2^14) -> two 7-bit digits as bf16."""
    lo = (x & DIGIT_MASK).astype(_BF16)
    hi = (x >> DIGIT_BITS).astype(_BF16)
    return lo, hi


def matmul_mod(x, T, m, mu):
    """(x @ T) mod m, columnwise moduli m [J], exactly, for x [B, J'] and
    T [J', J] residues < 2^14 with J' <= 638.

    Each digit-plane sum is <= 127^2 * J' < 2^23.3, exact in f32.  The two
    middle planes are cast to uint32 BEFORE they are added: their sum can
    reach 2^24.3, where f32 no longer holds every integer.  The
    2^14-shifted recombination is reduced in two Barrett steps to stay
    inside uint32; its first input is < 2^30 for integer-Barrett contexts
    (no modulus below 2^13 leaves k <= 435) and < 2^30.4 < 2^31 for the
    f32-reciprocal flavour (see barrett_reduce).
    """
    xlo, xhi = _digit_split(x)
    Tlo, Thi = _digit_split(T)

    def mm(a, b):
        return jnp.dot(a, b, preferred_element_type=_F32).astype(_U32)

    s_ll = mm(xlo, Tlo)
    mid = mm(xlo, Thi) + mm(xhi, Tlo)  # < 2^24.3: added in uint32
    s_hh = mm(xhi, Thi)
    # value = s_ll + mid*2^7 + s_hh*2^14
    t = barrett_reduce((s_hh << DIGIT_BITS) + mid, m, mu)  # < 2^31 in, < m out
    return barrett_reduce((t << DIGIT_BITS) + s_ll, m, mu)


def rns_mont_mul(x, y, c):
    """One RNS Montgomery multiply: x, y [B, K] residues of values < 3N;
    returns residues of x*y*M_A^{-1} mod N (a representative < 3N).

    ``c`` is the dict from RNSContext.device_consts().
    """
    k = c["T1"].shape[0]
    mods, mu = c["mods"], c["barrett"]
    mA, muA = mods[:k], mu[:k]
    mBx, muBx = mods[k:], mu[k:]

    s = mulmod(x, y, mods, mu)  # [B, K]
    s_A, s_Bx = s[..., :k], s[..., k:]

    # sigma for the extension (q and the (M_A/a_i)^{-1} factor fused into
    # one constant: sigma = s * (-N^{-1} (M_A/a_i)^{-1}) mod a_i)
    sigma = mulmod(s_A, c["sigma_c_A"], mA, muA)  # [B, k]

    # Kawamura alpha estimate (may undershoot by exactly 1, never overshoot)
    frac = jnp.sum(sigma.astype(_F32) * c["inv_a_f32"], axis=-1)
    alpha = jnp.maximum(jnp.floor(frac - ALPHA_MARGIN), 0.0).astype(_U32)  # [B]

    # extend q to base B + m_r: the alpha correction rides the matmul as an
    # extra lhs column against the (-M_A mod b_j) row of T1ext
    x_ext = jnp.concatenate([sigma, alpha[..., None]], axis=-1)  # [B, k+1]
    q_hat = matmul_mod(x_ext, c["T1ext"], mBx, muBx)  # [B, k+1]

    # r = (s + q_hat * N) * M_A^{-1}  in base B + m_r
    t = barrett_reduce(s_Bx + q_hat * c["N_B"], mBx, muBx)
    r_Bx = mulmod(t, c["MAinv_B"], mBx, muBx)  # [B, k+1]
    r_B, r_mr = r_Bx[..., :k], r_Bx[..., k]

    # exact Shenoy extension of r back to base A via m_r
    mB, muB = mods[k : 2 * k], mu[k : 2 * k]
    m_r, mu_r = mods[2 * k], mu[2 * k]
    sigma2 = mulmod(r_B, c["MBj_inv_B"], mB, muB)  # [B, k]
    ext_r = matmul_mod(sigma2, c["T2r"][:, None], m_r, mu_r)[..., 0]  # [B]
    diff = jnp.where(ext_r >= r_mr, ext_r - r_mr, ext_r + m_r - r_mr)
    alpha2 = mulmod(diff, c["MBinv_mr"], m_r, mu_r)  # [B], exact alpha'
    ext_A = matmul_mod(sigma2, c["T2"], mA, muA)  # [B, k]
    corr_A = mulmod(alpha2[..., None], c["MB_mod_A"], mA, muA)
    r_A = jnp.where(ext_A >= corr_A, ext_A - corr_A, ext_A + mA - corr_A)

    return jnp.concatenate([r_A, r_Bx], axis=-1)  # [B, K]


def limbs_to_rns(x, c):
    """Standard 15-bit limbs [B, L] -> residues [B, K] (exact).

    Limbs are < 2^15 -> three digit planes (7+7+1 bits); matrix entries are
    < 2^14 -> two planes.  Each f32 accumulation is <= 127^2 * L, which
    stays < 2^24 for L < 1040 limbs (the widest input, a 4096-bit key's
    full n^2-width ciphertext, has ~550).
    """
    mods, mu = c["mods"], c["barrett"]
    Cin = c["Cin"]  # [L, K]

    d0 = (x & DIGIT_MASK).astype(_BF16)
    d1 = ((x >> DIGIT_BITS) & DIGIT_MASK).astype(_BF16)
    d2 = (x >> (2 * DIGIT_BITS)).astype(_BF16)  # 1 bit
    Tlo, Thi = _digit_split(Cin)

    def mm(a, b):
        return jnp.dot(a, b, preferred_element_type=_F32)

    acc = jnp.zeros(x.shape[:-1] + (Cin.shape[1],), _U32)
    for shift, d in ((0, d0), (DIGIT_BITS, d1), (2 * DIGIT_BITS, d2)):
        lo = mm(d, Tlo).astype(_U32)
        hi = mm(d, Thi).astype(_U32)
        v = barrett_reduce((hi << DIGIT_BITS) + lo, mods, mu)  # < m
        # shift the digit plane up: multiply by 2^shift mod m (shift <= 14)
        acc = barrett_reduce(acc + (v << shift), mods, mu)
    return acc


def rns_to_limbs(x_rns, c):
    """Residues [B, K] -> canonical 15-bit limbs [B, Lout] of the exact value
    (< 3N; callers conditionally subtract N afterwards).

    value = sum_i sigma_i * (M_A/a_i) - alpha * M_A with sigma_i = x_i *
    (M_A/a_i)^{-1} mod a_i and exact alpha from the redundant residue.
    """
    from .montgomery import canonicalize  # local import to avoid cycle

    k = c["T1"].shape[0]
    mods, mu = c["mods"], c["barrett"]
    mA, muA = mods[:k], mu[:k]
    m_r, mu_r = mods[2 * k], mu[2 * k]

    x_A = x_rns[..., :k]
    x_mr = x_rns[..., 2 * k]
    sigma = mulmod(x_A, c["MAi_inv_A"], mA, muA)  # [B, k]

    # exact alpha via m_r:  alpha = (sum sigma_i*(M_A/a_i) - x) / M_A mod m_r
    ext_r = matmul_mod(sigma, c["T1"][:, -1:], m_r, mu_r)[..., 0]
    diff = jnp.where(ext_r >= x_mr, ext_r - x_mr, ext_r + m_r - x_mr)
    MAinv_mr = c["MAinv_B"][-1]
    alpha = mulmod(diff, MAinv_mr, m_r, mu_r)  # [B] < k

    # T = sum_i sigma_i * limbs(M_A/a_i): 14-bit x 15-bit products, exact via
    # digit planes; accumulate into u32 limb columns then carry-resolve.
    slo, shi = _digit_split(sigma)
    A_l = c["Aout_limbs"]  # [k, Lout] limbs < 2^15
    Llo = (A_l & DIGIT_MASK).astype(_BF16)
    Lmid = ((A_l >> DIGIT_BITS) & DIGIT_MASK).astype(_BF16)
    Lhi = (A_l >> (2 * DIGIT_BITS)).astype(_BF16)

    def mm(a, b):
        return jnp.dot(a, b, preferred_element_type=_F32)

    planes = []
    for shift_s, sd in ((0, slo), (DIGIT_BITS, shi)):
        for shift_l, Ld in ((0, Llo), (DIGIT_BITS, Lmid), (2 * DIGIT_BITS, Lhi)):
            planes.append((shift_s + shift_l, mm(sd, Ld).astype(_U32)))
    # Combine the digit planes into limb columns.  A plane p at limb column
    # l with weight 2^shift contributes p * 2^(shift mod 15) at column
    # l + shift//15; to stay inside uint32 (p < 2^23.3) split each shifted
    # plane at the limb boundary:  p*2^s = (p & (2^(15-s)-1))<<s
    #                              + (p >> (15-s)) * 2^15.
    acc = jnp.zeros_like(planes[0][1])

    def shift_cols(arr, by):
        if by == 0:
            return arr
        pad = jnp.zeros(arr.shape[:-1] + (by,), _U32)
        return jnp.concatenate([pad, arr[..., :-by]], axis=-1)

    for shift, p in planes:
        col, s = divmod(shift, LIMB_BITS)
        lo_part = (p & ((1 << (LIMB_BITS - s)) - 1)) << jnp.uint32(s)
        hi_part = p >> jnp.uint32(LIMB_BITS - s)
        acc = acc + shift_cols(lo_part, col) + shift_cols(hi_part, col + 1)
    big = canonicalize(acc)  # [B, Lout] canonical limbs of sum sigma*MAi

    # subtract alpha * M_A  (alpha < k <= 2^13: one scalar-x-vector product)
    MA_l = c["MA_limbs"]  # [Lout]
    prod = alpha[..., None] * MA_l  # < 2^13 * 2^15 = 2^28
    lo = prod & ((1 << LIMB_BITS) - 1)
    hi = prod >> LIMB_BITS
    sub = canonicalize(
        lo + jnp.concatenate([jnp.zeros_like(hi[..., :1]), hi[..., :-1]], -1)
    )
    from .bigint import sub_borrow

    diff_l, borrow = sub_borrow(big, sub)
    return diff_l  # borrow must be zero: value >= 0


# ---------------------------------------------------------------------------
# windowed exponentiation
# ---------------------------------------------------------------------------


def rns_mont_exp(x_rns, windows, c):
    """x^e mod N via fixed 4-bit windows (MS window first), all in RNS.

    x_rns: [B, K] residues of any x < M_A (the first, to-Montgomery
    multiply contracts it below 3N — so CRT decrypt can feed a full
    n^2-width ciphertext into the p^2/q^2 systems); windows [B, NW], or
    [1, NW] for one exponent shared by every row.  Returns residues of a
    representative of x^e mod N, value < 2N.
    """
    nw = windows.shape[-1]
    B = x_rns.shape[0]
    K = x_rns.shape[-1]

    a = rns_mont_mul(x_rns, c["mont_sq"][None, :], c)  # to Montgomery form
    one = jnp.broadcast_to(c["mont_one"][None, :], (B, K)).astype(_U32)

    def table_step(prev, _):
        nxt = rns_mont_mul(prev, a, c)
        return nxt, nxt

    _, powers = jax.lax.scan(table_step, one, None, length=(1 << WINDOW_BITS) - 1)
    table = jnp.concatenate([one[None], powers], axis=0)  # [16, B, K]

    def body(i, acc):
        for _ in range(WINDOW_BITS):
            acc = rns_mont_mul(acc, acc, c)
        w = jax.lax.dynamic_slice_in_dim(windows, i, 1, axis=-1)[..., 0]
        w = jnp.broadcast_to(w, (B,))
        # The window is secret (decrypt's p-1/q-1, RAW's lambda): select
        # with a one-hot masked sum over all 16 entries, never a gather
        # indexed by w, so work and addresses do not depend on it.
        onehot = (w[None, :] == jnp.arange(16, dtype=_U32)[:, None]).astype(_U32)
        sel = jnp.sum(table * onehot[..., None], axis=0)
        return rns_mont_mul(acc, sel, c)

    acc = jax.lax.fori_loop(0, nw, body, one)
    # leave Montgomery domain: result value < 3N/M_A + 2N -> < 2N + 1
    return rns_mont_mul(acc, c["plain_one"][None, :], c)


# ---------------------------------------------------------------------------
# fixed-base exponentiation (DJN obfuscators hs^r)
# ---------------------------------------------------------------------------

FB_WINDOW_BITS = 8  # one table per exponent byte
FB_TABLE = 1 << FB_WINDOW_BITS


def fb_num_windows(ebits: int) -> int:
    """Byte positions NP of the fixed-base table for ``ebits``-bit
    exponents (rounded up to a multiple of 8 to bound jit variants)."""
    nbytes = -(-ebits // FB_WINDOW_BITS)
    return max(8, -(-nbytes // 8) * 8)


def fb_table_planes(g_rns, c):
    """Per-key fixed-base table from g_rns [NP, K]: residues of
    g_i = base^(256^i) mod N.

    Entry [i, j] is g_i^j in Montgomery form (g_i^j * M_A, value < 3N),
    built by NP batched power chains of 255 RNS Montgomery multiplies.
    Returned as the two 7-bit digit planes of every residue, side by side,
    in bf16: [NP, 256, 2K] (lo | hi), ready for rns_fb_exp's one-hot
    matmul gather.
    """
    gm = rns_mont_mul(g_rns, c["mont_sq"][None, :], c)  # Montgomery form
    one = jnp.broadcast_to(c["mont_one"][None, :], gm.shape).astype(_U32)

    def step(prev, _):
        nxt = rns_mont_mul(prev, gm, c)
        return nxt, nxt

    _, powers = jax.lax.scan(step, one, None, length=FB_TABLE - 1)
    table = jnp.concatenate([one[None], powers], axis=0)  # [256, NP, K]
    lo, hi = _digit_split(table.transpose(1, 0, 2))
    return jnp.concatenate([lo, hi], axis=-1)


def rns_fb_exp(planes, win_bytes, c, mont_out=False):
    """base^e mod N from the fixed-base table: one table multiply per
    exponent byte, no squarings.

    planes: [NP, 256, 2K] from :func:`fb_table_planes`; win_bytes [B, NP]
    exponent bytes, least significant first.  Returns [B, K] residues of
    a representative <= 2N of base^e — or, with ``mont_out``, of
    base^e * M_A (value < 3N, Montgomery form), so that the caller's next
    rns_mont_mul doubles as the leave-Montgomery multiply.
    """
    NP = planes.shape[0]
    K = planes.shape[-1] // 2
    ids = jnp.arange(FB_TABLE, dtype=jnp.int32)[None, :]

    def select(i):
        w = jax.lax.dynamic_index_in_dim(win_bytes, i, 1, keepdims=False)
        # The exponent bytes are secret: select the table row with a
        # one-hot [B, 256] matmul (exact — one nonzero 0/1 term per sum),
        # never a gather indexed by the byte, so work and addresses do not
        # depend on it.  The position i is public.
        onehot = (w.astype(jnp.int32)[:, None] == ids).astype(_BF16)
        tab = jax.lax.dynamic_index_in_dim(planes, i, 0, keepdims=False)
        s = jnp.dot(onehot, tab, preferred_element_type=_F32).astype(_U32)
        return s[:, :K] + (s[:, K:] << DIGIT_BITS)

    acc = jax.lax.fori_loop(
        1, NP, lambda i, acc: rns_mont_mul(acc, select(i), c), select(0)
    )
    if mont_out:
        return acc
    return rns_mont_mul(acc, c["plain_one"][None, :], c)
