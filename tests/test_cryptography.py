"""Cryptography tests mirroring the reference's test/test_cryptography.cpp:

* random roundtrip tests (CryptoTest, test_cryptography.cpp:67-97),
* concurrent-use smoke test (the OMP app-level analog),
* the ISO/IEC 18033-6 compliance KAT (test_cryptography.cpp:99-241) — the
  bit-exactness oracle shared with the reference: fixed p, q and injected
  obfuscator randoms must reproduce the exact ciphertext hex strings.
"""

import concurrent.futures
import random

import pytest

import pailliercryptolib_tpu as ptpu

from iso_vectors import (  # ISO/IEC 18033-6 vectors (tests/iso_vectors.py)
    ISO_C1,
    ISO_C1C2,
    ISO_C2,
    ISO_M1,
    ISO_M1M2,
    ISO_M2,
    ISO_P,
    ISO_Q,
    ISO_R0,
    ISO_R1,
)


def _roundtrip(nbits, djn, values):
    key = ptpu.generate_keypair(nbits, enable_DJN=djn)
    pt = ptpu.PlainText(values)
    ct = key.pub_key.encrypt(pt)
    dt = key.priv_key.decrypt(ct)
    assert dt.texts == [v % key.pub_key.n for v in values]
    return key


@pytest.mark.parametrize("djn", [True, False])
def test_roundtrip_random_512(djn, rng):
    values = [rng.getrandbits(32) for _ in range(20)]
    _roundtrip(512, djn, values)


def test_roundtrip_wide_values(rng):
    key = ptpu.generate_keypair(512, enable_DJN=True)
    values = [0, 1, key.pub_key.n - 1, rng.getrandbits(500)]
    ct = key.pub_key.encrypt(ptpu.PlainText(values))
    dt = key.priv_key.decrypt(ct)
    assert dt.texts == [v % key.pub_key.n for v in values]


def test_concurrent_api_use(rng):
    """App-level concurrency smoke test (the OMP test analog,
    test_cryptography.cpp:18-65): the functional API must be reentrant."""
    key = ptpu.generate_keypair(512, enable_DJN=True)
    values = [[rng.getrandbits(32) for _ in range(5)] for _ in range(6)]

    def work(vals):
        ct = key.pub_key.encrypt(ptpu.PlainText(vals))
        return key.priv_key.decrypt(ct).texts

    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        results = list(ex.map(work, values))
    assert results == values


@pytest.mark.slow
def test_roundtrip_random_2048(rng):
    values = [rng.getrandbits(32) for _ in range(20)]
    _roundtrip(2048, True, values)


def test_iso_iec_18033_6_compliance():
    """Bit-exact KAT (test_cryptography.cpp:99-241, batch-2 core).

    Non-DJN key from fixed ISO p, q; obfuscator randoms injected via
    set_random.  Ciphertexts, their homomorphic sum, and the decrypted sum
    must match the published vectors exactly.
    """
    n = ISO_P * ISO_Q
    pk = ptpu.PublicKey(n, n.bit_length())
    sk = ptpu.PrivateKey(pk, ISO_P, ISO_Q)

    pk.set_random([ISO_R0, ISO_R1])
    pt = ptpu.PlainText([ISO_M1, ISO_M2])
    ct = pk.encrypt(pt)

    dt = sk.decrypt(ct)
    assert dt.texts == [ISO_M1, ISO_M2]

    assert ct.get_element_hex(0) == ptpu.models.texts.int_to_hex(ISO_C1)
    assert ct.get_element_hex(1) == ptpu.models.texts.int_to_hex(ISO_C2)
    assert ct.get_element(0) == ISO_C1
    assert ct.get_element(1) == ISO_C2

    a = ptpu.CipherText(pk, ct.get_element(0))
    b = ptpu.CipherText(pk, ct.get_element(1))
    s = a + b
    assert s.get_element(0) == ISO_C1C2

    dt_sum = sk.decrypt(s)
    assert dt_sum.get_element(0) == ISO_M1M2


@pytest.mark.slow
def test_iso_iec_18033_6_compliance_full_batch():
    """Full 21-element KAT batch exactly as the reference runs it."""
    num_values = 21
    n = ISO_P * ISO_Q
    pk = ptpu.PublicKey(n, n.bit_length())
    sk = ptpu.PrivateKey(pk, ISO_P, ISO_Q)

    irs = [ISO_R0] * num_values
    pts = [ISO_M1] * num_values
    irs[1] = ISO_R1
    pts[1] = ISO_M2
    pk.set_random(irs)
    ct = pk.encrypt(ptpu.PlainText(pts))
    dt = sk.decrypt(ct)
    assert dt.texts == pts
    assert ct.get_element(0) == ISO_C1
    assert ct.get_element(1) == ISO_C2


@pytest.mark.slow
def test_roundtrip_random_4096(rng):
    """4096-bit key envelope (the reference caps at 2048 — a mbx_exp_mb8
    operand-width limit, ipcl/keygen.cpp:10-11; the limb/RNS kernels here
    are width-generic, so the full claimed range is exercised)."""
    values = [rng.getrandbits(32) for _ in range(8)]
    _roundtrip(4096, True, values)


@pytest.mark.slow
def test_encrypt_deterministic_oracle_4096(rng):
    """4096-bit determinism: injected obfuscator randoms make encryption a
    pure function; ciphertexts must equal the Python pow() oracle
    (the setRandom hook contract, ipcl/pub_key.cpp:51-64,92-97)."""
    key = ptpu.generate_keypair(4096, enable_DJN=True)
    pk = key.pub_key
    n, n2 = pk.n, pk.n * pk.n
    msgs = [rng.getrandbits(32) for _ in range(3)]
    rs = [rng.getrandbits(pk.randbits) for _ in range(3)]
    pk.set_random(list(rs))
    ct = pk.encrypt(ptpu.PlainText(msgs))
    for i, (m, r) in enumerate(zip(msgs, rs)):
        assert ct.get_element(i) == (n * m + 1) * pow(pk.hs, r, n2) % n2
