"""Fixed-base RNS exponentiation (ops/rns.py fb_table_planes / rns_fb_exp)
vs Python pow()."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

import pailliercryptolib_tpu as ptpu
from pailliercryptolib_tpu.ops import limbs as lb
from pailliercryptolib_tpu.ops import paillier_ops as pops
from pailliercryptolib_tpu.ops import rns


@pytest.fixture(scope="module")
def fb256():
    rng = random.Random(4242)
    N = rng.getrandbits(256) | (1 << 255) | 1
    c = rns.RNSContext.create(N)
    conv = c.device_consts()
    base = rng.randrange(2, N)
    NP = rns.fb_num_windows(64)  # 64-bit exponents -> 8 byte-windows
    g = [base]
    for _ in range(NP - 1):
        g.append(pow(g[-1], 256, N))
    g_limbs = jnp.asarray(lb.ints_to_limbs(g, c.Lin))
    planes = pops.fb_table_stage(g_limbs, conv)
    return rng, N, c, conv, base, NP, planes


def _exps(rng, B):
    return [rng.getrandbits(64) for _ in range(B - 3)] + [0, 1, (1 << 64) - 1]


def test_fb_table_entries(fb256):
    """Spot-check table entries: [i, j] = Mont(base^(j * 2^(8 i))), stored
    as two 7-bit digit planes side by side (lo | hi)."""
    rng, N, c, conv, base, NP, planes = fb256
    p = np.asarray(planes.astype(jnp.float32)).astype(np.uint32)
    assert p.shape == (NP, rns.FB_TABLE, 2 * c.K)
    table = p[..., : c.K] + (p[..., c.K :] << 7)
    for i, j in [(0, 0), (0, 1), (0, 255), (3, 17), (NP - 1, 2)]:
        want = pow(base, j * (1 << (8 * i)), N) * c.MA % N
        for m, v in zip(c.mods, table[i, j]):
            assert int(v) == want % int(m), (i, j)


@pytest.mark.parametrize("B", [5, 128])
def test_fb_modexp_matches_pow(fb256, B):
    """Any batch size (5 is no multiple of the engines' 128-row padding)."""
    rng, N, c, conv, base, NP, planes = fb256
    exps = _exps(rng, B)
    wb = jnp.asarray(lb.ints_to_bytes_le(exps, NP))
    res = pops.rns_fb_modexp_stage(planes, wb, conv)
    vals = lb.limbs_to_ints(np.asarray(rns.rns_to_limbs(res, conv)))
    for e, v in zip(exps, vals):
        assert v % N == pow(base, e, N)
        assert v <= 2 * N


def test_fb_modexp_production_tile(fb256):
    """The production encrypt configuration: a 256-row batch with the
    result left in Montgomery form (mont_out, the encrypt/obfuscate
    fused stages), i.e. base^e * M_A mod N as a < 3N representative."""
    rng, N, c, conv, base, NP, planes = fb256
    B = 256
    exps = _exps(rng, B)
    wb = jnp.asarray(lb.ints_to_bytes_le(exps, NP))
    res = pops.rns_fb_modexp_stage(planes, wb, conv, mont_out=True)
    vals = lb.limbs_to_ints(np.asarray(rns.rns_to_limbs(res, conv)))
    for e, v in zip(exps, vals):
        assert v % N == pow(base, e, N) * c.MA % N
        assert v < 3 * N


def test_engine_djn_uses_fixedbase(rng):
    """End-to-end DJN encrypt on the default (RNS) backend exercises the
    fixed-base path (randbits fits the table) and stays roundtrip-correct."""
    key = ptpu.generate_keypair(256, enable_DJN=True)
    assert key.pub_key._engine.backend == "rns"
    vals = [rng.getrandbits(32) for _ in range(5)]
    ct = key.pub_key.encrypt(ptpu.PlainText(vals))
    assert key.pub_key._engine._fb is not None  # table was built and used
    assert key.priv_key.decrypt(ct).texts == vals
