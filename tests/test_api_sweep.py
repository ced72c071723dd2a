"""API-surface tests: standalone obfuscation, prime export, injected-random
consumption, and late-DJN-enable engine refresh.

Mirrors the reference's standalone public APIs: getPrimeBN
(ipcl/include/ipcl/ipcl.hpp:29), applyObfuscator (ipcl/pub_key.cpp:82-90),
setRandom (ipcl/pub_key.cpp:92-95), enableDJN-after-construction
(ipcl/pub_key.cpp:32-49).
"""

import pytest

import pailliercryptolib_tpu as ptpu
from pailliercryptolib_tpu.models.keygen import miller_rabin


def test_miller_rabin_small_values():
    assert miller_rabin(2) and miller_rabin(3) and miller_rabin(5)
    assert not miller_rabin(0) and not miller_rabin(1)
    assert not miller_rabin(4) and not miller_rabin(9) and not miller_rabin(15)
    assert miller_rabin(4099)  # first prime past the sieve limit
    assert not miller_rabin(4097)  # 17 * 241


def test_get_prime_export():
    p = ptpu.get_prime(96)
    assert p.bit_length() == 96
    assert miller_rabin(p)
    p3 = ptpu.get_prime(96, mod4_is_3=True)
    assert p3 % 4 == 3 and miller_rabin(p3)


def test_set_random_consumes_fifo(rng):
    """Injected randoms are consumed one encrypt at a time — back-to-back
    injected encrypts must use successive values, not silently reuse."""
    key = ptpu.generate_keypair(256, enable_DJN=False)
    n, n2 = key.pub_key.n, key.pub_key.nsquare
    r0, r1 = rng.getrandbits(255) % n, rng.getrandbits(255) % n
    key.pub_key.set_random([r0, r1])
    m = 12345
    ct0 = key.pub_key.encrypt(ptpu.PlainText([m]))
    ct1 = key.pub_key.encrypt(ptpu.PlainText([m]))
    assert ct0.get_element(0) == (n * m + 1) * pow(r0, n, n2) % n2
    assert ct1.get_element(0) == (n * m + 1) * pow(r1, n, n2) % n2
    # exhausted: the hook disarms and fresh CSPRNG randoms take over
    ct2 = key.pub_key.encrypt(ptpu.PlainText([m]))
    assert key.priv_key.decrypt(ct2).texts == [m]


def test_set_random_insufficient_raises():
    key = ptpu.generate_keypair(256, enable_DJN=False)
    key.pub_key.set_random([3])
    with pytest.raises(ValueError, match="not enough injected"):
        key.pub_key.encrypt(ptpu.PlainText([1, 2]))


def test_apply_obfuscator_normal_known_answer(rng):
    """apply_obfuscator with an injected r must equal
    ct * r^n mod n^2 exactly (ipcl/pub_key.cpp:66-90)."""
    key = ptpu.generate_keypair(256, enable_DJN=False)
    n, n2 = key.pub_key.n, key.pub_key.nsquare
    m = 777
    ct = key.pub_key.encrypt(ptpu.PlainText([m]), make_secure=False)
    assert ct.get_element(0) == n * m + 1
    r = rng.getrandbits(255) % n
    key.pub_key.set_random([r])
    ct2 = key.pub_key.apply_obfuscator(ct)
    assert ct2.get_element(0) == (n * m + 1) * pow(r, n, n2) % n2
    assert key.priv_key.decrypt(ct2).texts == [m]


def test_apply_obfuscator_djn_known_answer(rng):
    """DJN path: ct * hs^r mod n^2 with an injected half-width r."""
    key = ptpu.generate_keypair(256, enable_DJN=True)
    pk = key.pub_key
    n2 = pk.nsquare
    m = 31337
    ct = pk.encrypt(ptpu.PlainText([m]), make_secure=False)
    r = rng.getrandbits(pk.randbits)
    pk.set_random([r])
    ct2 = pk.apply_obfuscator(ct)
    assert ct2.get_element(0) == ct.get_element(0) * pow(pk.hs, r, n2) % n2
    assert key.priv_key.decrypt(ct2).texts == [m]


def test_apply_obfuscator_batch_fresh(rng):
    key = ptpu.generate_keypair(256, enable_DJN=True)
    vals = [rng.getrandbits(32) for _ in range(5)]
    ct = key.pub_key.encrypt(ptpu.PlainText(vals))
    ct2 = key.pub_key.apply_obfuscator(ct)
    assert ct2.texts != ct.texts
    assert key.priv_key.decrypt(ct2).texts == vals


@pytest.mark.parametrize(
    "backend",
    ["xla", "rns"],
)
def test_enable_djn_after_engine_instantiation(backend):
    """Regression: enableDJN on a key whose engine already exists must
    refresh the engine's obfuscator width (randbits), not just hs —
    the fixed-base table is sized from it (ipcl/pub_key.cpp:131-137)."""
    key = ptpu.generate_keypair(256, enable_DJN=False)
    pk = key.pub_key
    pk._engine.backend = backend
    key.priv_key._engine.backend = backend
    vals = [11, 22]
    ct = pk.encrypt(ptpu.PlainText(vals))  # engine instantiated, non-DJN
    assert key.priv_key.decrypt(ct).texts == vals
    pk.enable_djn()
    assert pk._engine.randbits == pk.randbits and pk.randbits > 0
    ct2 = pk.encrypt(ptpu.PlainText(vals))  # DJN path with fresh table
    assert key.priv_key.decrypt(ct2).texts == vals
