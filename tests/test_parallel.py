"""Multi-device tests on the 8-device virtual CPU mesh.

What the reference cannot test at all (no distributed backend, SURVEY.md
§2.5/§4.6), this build tests in CI: batch-sharded encrypt, 2-D
{'crt','batch'} sharded CRT decrypt, and the driver-facing dryrun.
"""

import os
import sys

import jax
import numpy as np
import pytest

import pailliercryptolib_tpu as ptpu
from pailliercryptolib_tpu.models.engine import _round_windows
from pailliercryptolib_tpu.ops import limbs as lb
from pailliercryptolib_tpu.ops import paillier_ops as pops
from pailliercryptolib_tpu.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def key():
    return ptpu.generate_keypair(256, enable_DJN=True)


def test_mesh_shapes():
    m1 = pmesh.make_mesh(8)
    assert m1.axis_names == ("batch",)
    m2 = pmesh.make_mesh(8, crt_axis=True)
    assert m2.axis_names == ("crt", "batch")
    assert m2.devices.shape == (2, 4)


def test_sharded_encrypt_matches_local(key, rng):
    assert len(jax.devices()) >= 8
    pub = key.pub_key._engine
    B = 32
    m = [rng.getrandbits(31) for _ in range(B)]
    r = [rng.getrandbits(pub.randbits) for _ in range(B)]

    mesh = pmesh.make_mesh(8)
    enc = pmesh.sharded_encrypt_djn(mesh)
    nw = _round_windows(lb.num_windows(pub.randbits))
    m_a = pmesh.shard_batch(np.asarray(lb.ints_to_limbs(m, pub.Ln)), mesh)
    r_w = pmesh.shard_batch(np.asarray(lb.ints_to_windows(r, nw * 4)), mesh)
    n2_n, n2_n0inv, n2_r2, n2_one = pub.n2_args
    ct = enc(m_a, r_w, pub.n_limbs, n2_n, n2_n0inv, n2_r2, n2_one, pub.hs_limbs)
    got = lb.limbs_to_ints(np.asarray(ct))

    # reference: single-device engine with injected identical randoms
    key.pub_key.set_random(r)
    want = key.pub_key.encrypt(ptpu.PlainText(m)).texts
    key.pub_key._testv = False
    key.pub_key._test_r = []
    assert got == want


def test_sharded_crt_decrypt_roundtrip(key, rng):
    priv = key.priv_key._engine
    B = 32
    vals = [rng.getrandbits(31) for _ in range(B)]
    ct = key.pub_key.encrypt(ptpu.PlainText(vals))

    mesh = pmesh.make_mesh(8, crt_axis=True)
    dec = pmesh.sharded_decrypt_crt(mesh)
    ct_a = pmesh.shard_batch(
        np.asarray(lb.ints_to_limbs(ct.texts, 2 * priv.Lp2)), mesh
    )
    out = dec(
        ct_a,
        priv.sq_n, priv.sq_n0inv, priv.sq_r2, priv.sq_one,
        priv.exp_wins, priv.hensel, priv.hfun,
        priv.pq_n, priv.pq_n0inv, priv.pq_r2,
        priv.pinv_q, priv.p_limbs,
    )
    got = lb.limbs_to_ints(np.asarray(out))
    assert got == vals


def test_dryrun_multichip():
    sys.path.insert(0, REPO)
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


@pytest.mark.slow
def test_entry_compiles():
    sys.path.insert(0, REPO)
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    out = fn(*args)
    jax.tree.map(lambda x: x.block_until_ready(), out)
    assert out.shape[0] == args[0].shape[0]


def test_shard_stage_rns_modexp_matches_pow(rng):
    """The RNS modexp stage sharded as the engines shard it (shard_stage)
    on a 2-device CPU mesh, against pow()."""
    import random

    from pailliercryptolib_tpu.ops import rns

    r2 = random.Random(123)
    N = r2.getrandbits(128) | (1 << 127) | 1
    c = rns.RNSContext.create(N)
    conv = c.device_consts()
    mesh = pmesh.make_mesh(2)
    B = 16
    bases = [r2.randrange(N) for _ in range(B)]
    exps = [r2.getrandbits(16) for _ in range(B)]
    x = pmesh.shard_batch(np.asarray(lb.ints_to_limbs(bases, c.Lin)), mesh)
    wins = pmesh.shard_batch(np.asarray(lb.ints_to_windows(exps, 16)), mesh)
    stage = pmesh.shard_stage(mesh, pops.rns_modexp_stage, (0, 1))
    assert pmesh.shard_stage(mesh, pops.rns_modexp_stage, (0, 1)) is stage
    out = stage(x, wins, conv)
    assert out.sharding.spec[0] == "batch"
    got = lb.limbs_to_ints(np.asarray(rns.rns_to_limbs(out, conv)))
    for g, b, e in zip(got, bases, exps):
        assert g % N == pow(b, e, N)
        assert g <= 2 * N
