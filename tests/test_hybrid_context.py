"""Hybrid work-split + runtime-context wiring tests.

The hybrid mechanism mirrors the reference's QAT/IPP batch split
(ipcl/mod_exp.cpp:688-732) with per-op OPTIMAL gating
(ipcl/utils/common.hpp:18-23); the context wiring mirrors
initializeContext("CPU"/...) (ipcl/utils/context.cpp:16-44).  These tests
fail if either knob stops being connected to execution.
"""

import jax
import pytest

import pailliercryptolib_tpu as ptpu
from pailliercryptolib_tpu.ops import dispatch
from pailliercryptolib_tpu.parallel import context as pctx


@pytest.fixture(autouse=True)
def _reset_knobs():
    yield
    dispatch.set_hybrid_off()
    pctx.terminate_context()


@pytest.fixture(scope="module")
def key():
    k = ptpu.generate_keypair(256, enable_DJN=True)
    for e in (k.pub_key._engine, k.priv_key._engine):
        assert e.backend == "rns"  # the default: the primary of a split
    return k


def _spy(engine, method):
    calls = []
    orig = getattr(engine, method)

    def wrapper(*args):
        calls.append(args)
        return orig(*args)

    setattr(engine, method, wrapper)
    return calls


def test_hybrid_half_splits_encrypt(key, rng):
    """HALF mode must route half of every batch to the CIOS twin."""
    pk = key.pub_key
    sec_calls = _spy(pk._engine.secondary, "_encrypt_djn_impl")
    dispatch.set_hybrid_mode(dispatch.HybridMode.HALF)
    vals = [rng.getrandbits(32) for _ in range(4)]
    ct = pk.encrypt(ptpu.PlainText(vals))
    assert len(sec_calls) == 1 and len(sec_calls[0][0]) == 2  # tail rows
    assert key.priv_key.decrypt(ct).texts == vals


def test_hybrid_ratio_splits_decrypt(key, rng):
    """An explicit ratio must split host-input decrypts at int(r*size)."""
    pk, sk = key.pub_key, key.priv_key
    vals = [rng.getrandbits(32) for _ in range(5)]
    ct = pk.encrypt(ptpu.PlainText(vals))
    ct_host = ptpu.CipherText(pk, ct.texts)  # host ints: split applies
    sec_calls = _spy(sk._engine.secondary, "_decrypt_crt_impl")
    dispatch.set_hybrid_ratio(0.4)
    assert dispatch.get_hybrid_mode() == dispatch.HybridMode.UNDEFINED
    dt = sk.decrypt(ct_host)
    assert len(sec_calls) == 1 and len(sec_calls[0][0]) == 3  # 5 - int(.4*5)
    assert dt.texts == vals


def test_hybrid_xla_mode_all_secondary(key, rng):
    """HybridMode.XLA (the reference's IPP) runs everything on the twin."""
    pk = key.pub_key
    sec_calls = _spy(pk._engine.secondary, "_encrypt_djn_impl")
    dispatch.set_hybrid_mode(dispatch.HybridMode.XLA)
    vals = [rng.getrandbits(32) for _ in range(3)]
    ct = pk.encrypt(ptpu.PlainText(vals))
    assert len(sec_calls) == 1 and len(sec_calls[0][0]) == 3
    assert key.priv_key.decrypt(ct).texts == vals


def test_hybrid_optimal_default_no_split(rng):
    """OPTIMAL (default) keeps everything on the RNS backend: the twin
    engine is never even instantiated."""
    k = ptpu.generate_keypair(256, enable_DJN=True)
    assert k.pub_key._engine.backend == "rns"
    vals = [rng.getrandbits(32) for _ in range(3)]
    ct = k.pub_key.encrypt(ptpu.PlainText(vals))
    assert k.priv_key.decrypt(ct).texts == vals
    assert k.pub_key._engine._secondary is None
    assert k.priv_key._engine._secondary is None


def test_hybrid_device_resident_skips_split(key, rng):
    """Device-resident ciphertexts stay on the primary (no host reslice)."""
    pk, sk = key.pub_key, key.priv_key
    dispatch.set_hybrid_mode(dispatch.HybridMode.HALF)
    vals = [rng.getrandbits(32) for _ in range(2)]
    ct = pk.encrypt(ptpu.PlainText(vals))  # hybrid-split output
    sec_calls = _spy(sk._engine.secondary, "_decrypt_crt_impl")
    assert sk.decrypt(ct).texts == vals  # DevLimbs payload: primary only
    assert sec_calls == []


def test_context_cpu_forces_xla_backend():
    pctx.initialize_context("CPU")
    k = ptpu.generate_keypair(256, enable_DJN=True)
    assert k.pub_key._engine.backend == "xla"
    assert k.priv_key._engine.backend == "xla"
    ct = k.pub_key.encrypt(ptpu.PlainText([1, 2, 3]))
    assert k.priv_key.decrypt(ct).texts == [1, 2, 3]


def test_context_mesh_shards_public_api(rng):
    """initialize_context with an 8-device mesh: the public encrypt/decrypt
    APIs shard the batch transparently."""
    ctx = pctx.initialize_context(mesh_devices=8)
    assert ctx.mesh.devices.size == 8
    k = ptpu.generate_keypair(256, enable_DJN=True)
    assert k.pub_key._engine.mesh is ctx.mesh
    vals = [rng.getrandbits(32) for _ in range(16)]
    ct = k.pub_key.encrypt(ptpu.PlainText(vals))
    # the ciphertext batch is physically sharded over the mesh
    sharding = ct.device_payload().arr.sharding
    assert isinstance(sharding, jax.sharding.NamedSharding)
    assert sharding.spec[0] == "batch"
    assert k.priv_key.decrypt(ct).texts == vals
    # homomorphic ops run sharded too
    s = ct + ct
    assert k.priv_key.decrypt(s).texts == [2 * v for v in vals]
    m3 = ct * ptpu.PlainText([3])
    assert k.priv_key.decrypt(m3).texts == [3 * v for v in vals]


def test_mesh_obfuscators_independent_across_shards(rng):
    """Under a sharded mesh the on-device ChaCha20 DRBG gets one seed row
    PER DEVICE (engine._seed_rows): encrypting the same plaintext in
    every row must yield pairwise-distinct ciphertexts — a replicated
    seed would repeat identical obfuscator blocks shard-for-shard."""
    ctx = pctx.initialize_context(mesh_devices=8)
    k = ptpu.generate_keypair(256, enable_DJN=True)
    assert k.pub_key._engine.backend == "rns"
    vals = [7] * 16  # identical plaintext, 2 rows per shard
    ct = k.pub_key.encrypt(ptpu.PlainText(vals))
    texts = ct.texts
    assert len(set(texts)) == len(texts)
    assert k.priv_key.decrypt(ct).texts == vals
    # the normal-mode (non-DJN) seed stage binds a static kwarg (ebits)
    # through shard_stage: same independence property, same mesh
    kn = ptpu.generate_keypair(256, enable_DJN=False)
    ctn = kn.pub_key.encrypt(ptpu.PlainText(vals))
    tn = ctn.texts
    assert len(set(tn)) == len(tn)
    assert kn.priv_key.decrypt(ctn).texts == vals


def test_context_idempotent_and_terminates():
    c1 = pctx.initialize_context("CPU")
    c2 = pctx.initialize_context("DEFAULT")  # idempotent: keeps the first
    assert c2 is c1
    assert pctx.is_running()
    pctx.terminate_context()
    assert not pctx.is_running()
    assert pctx.peek_context() is None
