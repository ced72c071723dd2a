"""RNS Montgomery arithmetic vs Python ints (the default backend's
correctness suite)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pailliercryptolib_tpu.ops import limbs as lb
from pailliercryptolib_tpu.ops import rns
from pailliercryptolib_tpu.ops.montgomery import MontConstants


def _odd(rng, nbits):
    return rng.getrandbits(nbits) | (1 << (nbits - 1)) | 1


@pytest.fixture(scope="module")
def ctx256():
    import random

    rng = random.Random(21)
    N = _odd(rng, 256)
    return rng, N, rns.RNSContext.create(N)


def test_context_invariants(ctx256):
    _, N, c = ctx256
    assert c.MA >= rns.GUARD_FACTOR * N
    assert c.MB >= rns.GUARD_FACTOR * N
    assert c.k < c.mr
    mods = [int(m) for m in c.mods]
    assert len(set(mods)) == len(mods)
    assert all((1 << 13) < m < (1 << 14) for m in mods)


@pytest.mark.slow
def test_max_modulus_gate_matches_allocator():
    """The width gate and create()'s allocator must agree exactly: create
    succeeds at rns_max_modulus_bits() and raises just past it (the gate
    simulates the allocator, so drift means a wrong fallback decision)."""
    import math

    top = rns.rns_max_modulus_bits()
    N = (1 << top) - 3  # odd, exactly `top` bits
    pool_prod = math.prod(rns._prime_pool())
    while math.gcd(N, pool_prod) != 1:  # N must be coprime to the pool
        N -= 2  # (Paillier moduli p*q / p^2 always are)
    c = rns.RNSContext.create(N)
    assert c.MA > N and c.MB > N
    with pytest.raises(ValueError):
        rns.RNSContext.create((1 << (top + 16)) - 3)


@pytest.mark.slow
def test_wide_pool_oracle_6400():
    """Wide-pool contexts (moduli below 2^13, reached by 6k+ -bit N — the
    4096-bit-key n^2 class) must stay exact: the f32-reciprocal
    barrett_reduce flavor ships via device_consts and every conversion /
    Montgomery product matches Python ints."""
    import random

    rng = random.Random(5)
    N = rng.getrandbits(6400) | (1 << 6399) | 1
    c = rns.RNSContext.create(N)
    assert rns.is_wide_pool(c)
    conv = c.device_consts()
    assert conv["barrett"].dtype == jnp.float32
    B = 4
    xs = [rng.randrange(N) for _ in range(B)]
    ys = [rng.randrange(N) for _ in range(B)]
    xr = rns.limbs_to_rns(jnp.asarray(lb.ints_to_limbs(xs, c.Lin)), conv)
    back = lb.limbs_to_ints(np.asarray(rns.rns_to_limbs(xr, conv)))
    assert [int(b) for b in back] == xs
    yr = rns.limbs_to_rns(jnp.asarray(lb.ints_to_limbs(ys, c.Lin)), conv)
    zr = rns.rns_mont_mul(xr, yr, conv)
    zv = lb.limbs_to_ints(np.asarray(rns.rns_to_limbs(zr, conv)))
    MAinv = pow(c.MA, -1, N)
    for v, a, b in zip(zv, xs, ys):
        assert v % N == (a * b * MAinv) % N and v < 3 * N
    es = [rng.getrandbits(24) for _ in range(B)]
    wins = jnp.asarray(lb.ints_to_windows(es, 24))
    out = rns.rns_mont_exp(xr, wins, conv)
    ov = lb.limbs_to_ints(np.asarray(rns.rns_to_limbs(out, conv)))
    for v, a, e in zip(ov, xs, es):
        assert v % N == pow(a, e, N)


def test_residue_conversion_roundtrip(ctx256):
    rng, N, c = ctx256
    cd = c.device_consts()
    vals = [rng.randrange(N) for _ in range(6)] + [0, 1, N - 1]
    x = jnp.asarray(lb.ints_to_limbs(vals, c.Lin))
    res = rns.limbs_to_rns(x, cd)
    got = np.asarray(res)
    for b, v in enumerate(vals):
        want = np.array([v % int(m) for m in c.mods], np.uint32)
        assert (got[b] == want).all(), f"residue mismatch at {b}"
    # back to limbs (values < 3N requirement satisfied: v < N)
    back = rns.rns_to_limbs(res, cd)
    ints = lb.limbs_to_ints(np.asarray(back))
    assert ints == vals


def test_rns_mont_mul(ctx256):
    rng, N, c = ctx256
    cd = c.device_consts()
    B = 8
    MAinv = pow(c.MA, -1, N)
    xs = [rng.randrange(3 * N) for _ in range(B - 1)] + [3 * N - 1]
    ys = [rng.randrange(3 * N) for _ in range(B - 1)] + [3 * N - 1]
    x = jnp.asarray(np.stack([c.to_residues(v) for v in xs]))
    y = jnp.asarray(np.stack([c.to_residues(v) for v in ys]))
    out = rns.rns_mont_mul(x, y, cd)
    vals = lb.limbs_to_ints(np.asarray(rns.rns_to_limbs(out, cd)))
    for xi, yi, v in zip(xs, ys, vals):
        assert v < 3 * N, "invariant violated"
        assert v % N == xi * yi * MAinv % N


def test_rns_mont_mul_iterated(ctx256):
    """Invariant stability over a chain of multiplications."""
    rng, N, c = ctx256
    cd = c.device_consts()
    MAinv = pow(c.MA, -1, N)
    x = jnp.asarray(np.stack([c.to_residues(rng.randrange(N)) for _ in range(4)]))
    ref = [int(v) for v in []]
    cur = x
    want = [lb.limbs_to_ints(np.asarray(rns.rns_to_limbs(x, cd)))[i] for i in range(4)]
    for _ in range(16):
        cur = rns.rns_mont_mul(cur, cur, cd)
        want = [w * w * MAinv % N for w in want]
    got = lb.limbs_to_ints(np.asarray(rns.rns_to_limbs(cur, cd)))
    for g, w in zip(got, want):
        assert g < 3 * N and g % N == w


@pytest.mark.parametrize("ebits", [1, 16, 64])
def test_rns_mont_exp(ctx256, ebits):
    rng, N, c = ctx256
    cd = c.device_consts()
    B = 8
    bases = [rng.randrange(N) for _ in range(B)]
    exps = [rng.getrandbits(ebits) for _ in range(B - 2)] + [0, 1]
    x = jnp.asarray(np.stack([c.to_residues(v) for v in bases]))
    wins = jnp.asarray(lb.ints_to_windows(exps, ebits))
    out = rns.rns_mont_exp(x, wins, cd)
    vals = lb.limbs_to_ints(np.asarray(rns.rns_to_limbs(out, cd)))
    for b, e, v in zip(bases, exps, vals):
        assert v % N == pow(b, e, N)
        assert v <= 2 * N


@pytest.mark.slow
def test_rns_mont_exp_2048key_shape():
    """Full 4096-bit modulus (2048-bit-key n^2 shape), 128-bit exponents."""
    import random

    rng = random.Random(31)
    N = _odd(rng, 4096)
    c = rns.RNSContext.create(N)
    cd = c.device_consts()
    B = 4
    bases = [rng.randrange(N) for _ in range(B)]
    exps = [rng.getrandbits(128) for _ in range(B)]
    x = jnp.asarray(np.stack([c.to_residues(v) for v in bases]))
    wins = jnp.asarray(lb.ints_to_windows(exps, 128))
    out = rns.rns_mont_exp(x, wins, cd)
    vals = lb.limbs_to_ints(np.asarray(rns.rns_to_limbs(out, cd)))
    for b, e, v in zip(bases, exps, vals):
        assert v % N == pow(b, e, N)


# ---------------------------------------------------------------------------
# the plain RNS backend's building blocks (ops/rns.py, ops/paillier_ops.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flavour", ["barrett", "f32"])
def test_matmul_mod_exact_at_widest_k(flavour):
    """matmul_mod over k + 1 = 638 terms (a 4096-bit key's n^2 context):
    every operand 16380 but one 16379, modulo 16381.  The two middle
    digit planes each stay below 2^24, but their sum does not, so adding
    them in f32 (rather than uint32) returns 511 instead of 639."""
    m = np.array([16381], np.uint32)
    mu = rns._barrett_consts(m) if flavour == "barrett" else rns.inv_f32(m)
    x = np.full((1, 638), 16380, np.uint32)
    x[0, -1] = 16379
    T = np.full((638, 1), 16380, np.uint32)
    want = int((x.astype(np.int64) @ T.astype(np.int64))[0, 0] % 16381)
    got = rns.matmul_mod(jnp.asarray(x), jnp.asarray(T), jnp.asarray(m),
                         jnp.asarray(mu))
    assert want == 639 and int(got[0, 0]) == want


def test_matmul_mod_random_wide_context():
    """matmul_mod on a real wide-pool context's T1ext (k = 637 class),
    uniform and all-maximal residues, against exact integers."""
    import random
    import sys

    sys.path.insert(0, _repo_root())
    import chip_smoke

    rng = random.Random(77)
    N = _odd(rng, 8192)
    conv = rns.RNSContext.create(N).device_consts()
    assert chip_smoke.check_matmul_mod(conv, rng, rows=8) == 637


def _repo_root():
    import os

    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_rns_has_no_f32_dots(ctx256):
    """Every dot in the RNS arithmetic takes bf16 digit planes (exact with
    f32 accumulation): an f32 x f32 dot could run as TF32 on a GPU."""
    import sys

    sys.path.insert(0, _repo_root())
    import chip_smoke

    _, _, c = ctx256
    assert chip_smoke.rns_f32_dots(c.device_consts()) == []


@pytest.mark.parametrize("shared", [False, True], ids=["per_row", "shared"])
def test_rns_modexp_stage_matches_pow(ctx256, shared):
    """The backend's modexp stage from limbs: per-row windows [B, NW] and
    one exponent shared by every row [1, NW]."""
    from pailliercryptolib_tpu.ops import paillier_ops as pops

    rng, N, c = ctx256
    conv = c.device_consts()
    B = 6
    bases = [rng.randrange(N) for _ in range(B - 1)] + [N - 1]
    exps = [rng.getrandbits(40) for _ in range(1 if shared else B)]
    wins = jnp.asarray(lb.ints_to_windows(exps, 40))
    x = jnp.asarray(lb.ints_to_limbs(bases, c.Lin))
    res = pops.rns_finalize_stage(
        pops.rns_modexp_stage(x, wins, conv), conv,
        jnp.asarray(lb.ints_to_limbs([N], c.Lin)[0]), c.Lin,
    )
    got = lb.limbs_to_ints(np.asarray(res))
    for i, (b, g) in enumerate(zip(bases, got)):
        assert g == pow(b, exps[0 if shared else i], N)


@pytest.fixture(scope="module")
def crt_pair():
    """A 256-bit-key-sized (p, q) pair with the engine's stacked (p^2, q^2)
    contexts, sized for a full n^2-width input."""
    import random

    from pailliercryptolib_tpu.models.keygen import get_prime

    p, q = sorted(get_prime(128) for _ in range(2))
    assert p != q
    pbits = max(p.bit_length(), q.bit_length())
    Lp2 = lb.limbs_for_bits(2 * pbits)
    in_limbs = 2 * Lp2
    bits = 2 * pbits + lb.LIMB_BITS + in_limbs.bit_length() + 1
    ctxs = [rns.RNSContext.create(h * h, in_limbs=in_limbs, product_bits=bits)
            for h in (p, q)]
    hp, hq = (cx.host_consts() for cx in ctxs)
    conv2 = {k: jnp.asarray(np.stack([hp[k], hq[k]])) for k in hp}
    return random.Random(3), p, q, in_limbs, conv2


def test_rns_crt_group_full_width_input(crt_pair):
    """The G=2 CRT group: one vmapped RNS modexp over (p^2, q^2) fed the
    FULL n^2-width ciphertext (the Cin fold reduces it mod h^2 inside the
    input conversion)."""
    import jax

    from pailliercryptolib_tpu.ops import paillier_ops as pops

    rng, p, q, in_limbs, conv2 = crt_pair
    n2 = (p * q) ** 2
    cts = [rng.randrange(n2) for _ in range(5)] + [n2 - 1]
    ews = [rng.getrandbits(32) for _ in range(2)]
    wins = jnp.asarray(np.stack([lb.ints_to_windows([e], 32) for e in ews]))
    ct = jnp.asarray(lb.ints_to_limbs(cts, in_limbs))
    res = jax.vmap(pops.rns_modexp_stage, in_axes=(None, 0, 0))(ct, wins, conv2)
    for g, (h, e) in enumerate(zip((p, q), ews)):
        conv = {k: v[g] for k, v in conv2.items()}
        got = lb.limbs_to_ints(np.asarray(rns.rns_to_limbs(res[g], conv)))
        for c_, v in zip(cts, got):
            assert v % (h * h) == pow(c_, e, h * h) and v <= 2 * h * h


def test_decrypt_crt_rns_matches_cios():
    """decrypt_crt_rns_op (RNS modexps + shared tail) agrees with the CIOS
    decrypt_crt_op on the same engine constants and ciphertexts."""
    import random

    import pailliercryptolib_tpu as ptpu
    from pailliercryptolib_tpu.ops import paillier_ops as pops

    rng = random.Random(11)
    key = ptpu.generate_keypair(256, enable_DJN=True)
    e = key.priv_key._engine
    vals = [rng.randrange(key.pub_key.n) for _ in range(4)]
    cts = key.pub_key.encrypt(ptpu.PlainText(vals)).texts
    ct = jnp.asarray(lb.ints_to_limbs(cts, 2 * e.Lp2))
    common = (e.exp_wins, e.hensel, e.hfun, e.pq_n, e.pq_n0inv, e.pq_r2,
              e.pinv_q, e.p_limbs)
    rns_out = pops.decrypt_crt_rns_op(ct, e.sq_n, *common, e.rns_crt)
    cios_out = pops.decrypt_crt_op(ct, e.sq_n, e.sq_n0inv, e.sq_r2, e.sq_one,
                                   *common)
    assert np.array_equal(np.asarray(rns_out), np.asarray(cios_out))
    assert lb.limbs_to_ints(np.asarray(rns_out)) == vals


def test_default_backend_is_rns():
    """No platform branch: the RNS backend is the default on the CPU as on
    a GPU, and unknown backend strings are refused."""
    from pailliercryptolib_tpu.ops import dispatch

    assert dispatch.default_backend() == "rns"
    with pytest.raises(ValueError):
        dispatch.check_backend("unknown")


@pytest.mark.parametrize("nbytes,L", [(67, 36), (15, 8), (129, 70)])
def test_bytes_to_limbs_dev_matches_host_codec(nbytes, L):
    """The on-device byte -> limb conversion of normal-mode obfuscator
    bases agrees with the host codec (ops/limbs.ints_to_limbs)."""
    import random

    from pailliercryptolib_tpu.ops.paillier_ops import _bytes_to_limbs_dev

    rng = random.Random(nbytes)
    xs = [rng.getrandbits(8 * nbytes) for _ in range(4)] + [0]
    by = np.array([list(x.to_bytes(nbytes, "little")) for x in xs], np.uint8)
    got = np.asarray(_bytes_to_limbs_dev(jnp.asarray(by), L))
    want = lb.ints_to_limbs([x % (1 << (15 * L)) for x in xs], L)
    assert np.array_equal(got, want)
