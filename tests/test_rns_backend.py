"""RNS backend: the full scheme through the engines on the default backend.

Arithmetic contracts live in tests/test_rns.py; this file drives
encrypt / decrypt CRT+RAW / CT*PT / obfuscation through the engines.
"""

import pailliercryptolib_tpu as ptpu


def _key(djn=True):
    key = ptpu.generate_keypair(256, enable_DJN=djn)
    for e in (key.pub_key._engine, key.priv_key._engine):
        assert e.backend == "rns"
    return key


def test_engine_rns_interpret_end_to_end():
    key = _key()
    vals = [7, 1234567, 0, 2**31 - 1]
    ct = key.pub_key.encrypt(ptpu.PlainText(vals))
    assert key.priv_key.decrypt(ct).texts == vals
    m3 = ct * ptpu.PlainText([3, 3, 3, 3])
    assert key.priv_key.decrypt(m3).texts == [3 * v for v in vals]
    key.priv_key.enable_crt = False
    assert key.priv_key.decrypt(ct).texts == vals


def test_engine_rns_interpret_normal_mode():
    key = _key(djn=False)
    vals = [5, 99]
    ct = key.pub_key.encrypt(ptpu.PlainText(vals))
    assert key.priv_key.decrypt(ct).texts == vals


def test_engine_rns_interpret_scalar_ctpt():
    """Scalar CT*PT runs one shared [1, NW] exponent (size-1 PT is NOT
    replicated host-side)."""
    key = _key()
    vals = [3, 14, 159]
    ct = key.pub_key.encrypt(ptpu.PlainText(vals))
    out = ct * ptpu.PlainText([7])
    assert key.priv_key.decrypt(out).texts == [7 * v for v in vals]


def test_engine_rns_interpret_apply_obfuscator():
    key = _key()
    vals = [42, 0, 7]
    ct = key.pub_key.encrypt(ptpu.PlainText(vals))
    ct2 = key.pub_key.apply_obfuscator(ct)
    assert ct2.texts != ct.texts  # fresh randomness changed the bytes
    assert key.priv_key.decrypt(ct2).texts == vals


def test_width_fallback_beyond_prime_pool():
    """The 12..14-bit prime pool reaches ~8.5k-bit moduli, so the FULL
    supported key envelope (n^2 to 8192 bits for 4096-bit keys) stays on
    the RNS backend; only hypothetical wider moduli downgrade to the
    width-generic CIOS ("xla") backend instead of crashing at RNS context
    creation."""
    import random

    from pailliercryptolib_tpu.models.engine import PublicEngine
    from pailliercryptolib_tpu.ops.rns import rns_max_modulus_bits, rns_supported

    assert rns_supported(4096)
    assert rns_supported(8192)  # 4096-bit keys' n^2: on the RNS path
    assert not rns_supported(16384)
    assert rns_max_modulus_bits() >= 8192

    rng = random.Random(9)
    # a 4096-bit n (n^2 = 8192 bits) stays on RNS
    n = rng.getrandbits(4096) | (1 << 4095) | 1
    assert PublicEngine(n, 4096, hs=None, randbits=2048,
                        backend="rns").backend == "rns"
    # synthetic 4300-bit odd n (n^2 ~ 8600 bits): beyond the pool, the
    # public engine downgrades
    nw = rng.getrandbits(4300) | (1 << 4299) | 1
    pub = PublicEngine(nw, 4300, hs=None, randbits=2150, backend="rns")
    assert pub.backend == "xla"
    # a 2048-bit n stays on RNS
    n2 = rng.getrandbits(2048) | (1 << 2047) | 1
    assert PublicEngine(n2, 2048, hs=None, randbits=1024,
                        backend="rns").backend == "rns"


def test_chacha20_rfc8439_vector():
    """The on-device obfuscator DRBG is RFC 8439 ChaCha20 — bit-exact
    against the specification's §2.3.2 keystream test vector (key =
    00..1f, nonce = 000000090000004a00000000, block counter 1)."""
    import jax.numpy as jnp
    import numpy as np

    from pailliercryptolib_tpu.ops.paillier_ops import _chacha20_blocks

    key = np.frombuffer(bytes(range(32)), np.uint32)
    nonce = np.frombuffer(bytes.fromhex("000000090000004a00000000"), np.uint32)
    ks = np.asarray(_chacha20_blocks(jnp.asarray(key), jnp.asarray(nonce), 2))
    want = (
        "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
        "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e"
    )
    assert ks[1].tobytes().hex() == want


def test_engine_grouped_decrypt_layout(rng):
    """CRT decrypt runs the (p^2, q^2) systems as ONE vmapped G=2 group:
    the engine stacks both contexts' constants (identical prime bases,
    so every array stacks) and the roundtrip holds."""
    import numpy as np

    key = _key()
    vals = [rng.getrandbits(32) for _ in range(4)]
    ct = key.pub_key.encrypt(ptpu.PlainText(vals))
    conv2 = key.priv_key._engine.rns_crt
    assert all(v.shape[0] == 2 for v in conv2.values())
    assert np.array_equal(conv2["mods"][0], conv2["mods"][1])
    assert key.priv_key.decrypt(ct).texts == vals
