#!/usr/bin/env python
"""End-to-end check of the Paillier main path on one NVIDIA GPU.

    python chip_smoke.py                 # one GPU: every phase below
    python chip_smoke.py --trace DIR     # also write a jax.profiler trace of
                                         # a warm 2048-bit encrypt + decrypt
    python chip_smoke.py --four          # four GPUs: the sharded path only

Phases, each printing one line as it ends (a failing phase raises, and the
script exits non-zero):

1. device: JAX's devices, and the card's name and power limit from
   nvidia-smi (read by a child process that stays off JAX).  Anything but
   a GPU platform is refused.
2. exactness: the digit-plane matmul (ops/rns.matmul_mod) against exact
   integers at the real k of every RNS context the main path builds, and
   no f32 x f32 dot left in the RNS arithmetic.
3. kat: the ISO/IEC 18033-6 known-answer vectors, bit-exact.
4. main: 2048-bit DJN keys at batch 2048 through the public API: encrypt
   (device RNG) / decrypt, CT+CT, CT*PT (per-row and scalar),
   apply_obfuscator, all decrypted and compared with exact integer
   arithmetic mod n; 64 rows bit-exact against (n*m+1)*hs^r mod n^2 under
   set_random; normal (non-DJN) encryption and RAW decryption on a small
   batch.
5. batches: the 2048-bit CRT decrypt of host-made ciphertexts at batches
   128, 1024, 2048 and 4096 (one compiled program per padded batch), so
   a fault that shows at one shape only fails the smoke.
6. wide: 4096-bit keys at batch 256: roundtrip plus the 64-row pow() check
   (n^2 is 8,192 bits: the wide-pool RNS context).
7. info: compile seconds and warm milliseconds per op, the compiled memory
   analysis of the encrypt and decrypt programs, and peak device memory.
   These are first observations, not benchmark metrics.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

MAIN_BITS, MAIN_BATCH = 2048, 2048  # bench.py's cell; IPCL's top batch size
WIDE_BITS, WIDE_BATCH = 4096, 256
DECRYPT_BATCHES = (128, 1024, 2048, 4096)
POW_ROWS = 64  # rows checked bit-exactly against Python pow()
SEED = 1  # every input is drawn from random.Random(SEED)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str = "check failed") -> None:
    """A phase's verdict (an explicit raise, kept under python -O)."""
    if not ok:
        raise AssertionError(what)


def import_package():
    """The package beside this script, or exit: the script is no use on
    its own."""
    sys.path.insert(0, HERE)
    sys.path.insert(1, os.path.join(HERE, "tests"))
    try:
        import pailliercryptolib_tpu as ptpu
    except ImportError as e:
        raise SystemExit(f"chip_smoke: package not found beside {HERE}: {e}")
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(ptpu.__file__)))
    if pkg_root != HERE:
        raise SystemExit(f"chip_smoke: package at {pkg_root}, not beside {HERE}")
    return ptpu


def phase_device(min_count: int = 1):
    import jax

    from pailliercryptolib_tpu.utils.devinfo import card_info

    devs = jax.devices()
    d = devs[0]
    log(f"[device] {devs}")
    log(f"[device] platform={d.platform} kind={d.device_kind} count={len(devs)}")
    if d.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU; JAX found platform {d.platform!r}"
        )
    if len(devs) < min_count:
        raise SystemExit(f"chip_smoke: needs {min_count} GPUs, found {len(devs)}")
    for line in card_info().splitlines():
        log(f"[device] nvidia-smi name, power.limit: {line}")
    return d


# ---------------------------------------------------------------------------
# phase 2: exactness of the digit-plane matmuls
# ---------------------------------------------------------------------------


def f32_dots(fn, *args):
    """dot_general equations of ``fn``'s jaxpr (sub-jaxprs included) that
    take an f32 operand without precision=HIGHEST (TF32 could run them)."""
    import jax
    from jax import lax

    bad = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                f32 = any(v.aval.dtype == "float32" for v in eqn.invars)
                prec = eqn.params.get("precision")
                highest = isinstance(prec, tuple) and all(
                    p == lax.Precision.HIGHEST for p in prec
                )
                if f32 and not highest:
                    bad.append(str(eqn))
            for v in eqn.params.values():
                for sub in v if isinstance(v, (tuple, list)) else (v,):
                    if hasattr(sub, "eqns"):
                        walk(sub)
                    elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return bad


def rns_f32_dots(conv):
    """f32 dots across every RNS entry point, traced with context ``conv``."""
    import jax.numpy as jnp

    from pailliercryptolib_tpu.ops import rns

    k = conv["T1"].shape[0]
    K = 2 * k + 1
    L = conv["Cin"].shape[0]
    x = jnp.zeros((2, K), jnp.uint32)
    bad = []
    bad += f32_dots(rns.rns_mont_mul, x, x, conv)
    bad += f32_dots(rns.limbs_to_rns, jnp.zeros((2, L), jnp.uint32), conv)
    bad += f32_dots(rns.rns_to_limbs, x, conv)
    bad += f32_dots(rns.rns_mont_exp, x, jnp.zeros((2, 8), jnp.uint8), conv)
    planes = jnp.zeros((8, rns.FB_TABLE, 2 * K), jnp.bfloat16)
    bad += f32_dots(rns.fb_table_planes, jnp.zeros((8, K), jnp.uint32), conv)
    bad += f32_dots(rns.rns_fb_exp, planes, jnp.zeros((2, 8), jnp.uint8), conv)
    return bad


def check_matmul_mod(conv, rng, rows: int = 256):
    """ops/rns.matmul_mod against exact integers at this context's k, on
    the two extension matrices the Montgomery multiply uses (T1ext, T2):
    uniform residues, all-maximal residues (m - 1), and the input at which
    adding two f32 digit planes loses exactness (every operand 16380 but
    one 16379, modulo 16381), in both Barrett flavours."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pailliercryptolib_tpu.ops import rns

    mm = jax.jit(rns.matmul_mod)
    c = {k: np.asarray(v) for k, v in conv.items()}
    k = c["T1"].shape[0]
    mods, mu = c["mods"], c["barrett"]

    def exact(x, T, m):
        return (x.astype(np.int64) @ T.astype(np.int64)) % m.astype(np.int64)

    def compare(x, T, m, mu_j, what):
        got = np.asarray(mm(jnp.asarray(x), jnp.asarray(T), jnp.asarray(m),
                            jnp.asarray(mu_j)))
        want = exact(x, T, m)
        if not np.array_equal(got.astype(np.int64), want):
            bad = int((got != want).sum())
            raise AssertionError(f"matmul_mod k={k} {what}: {bad} wrong")

    # x columns of T1ext: sigma mod a_i (i < k) plus the alpha column (< k+1)
    cases = (
        ("T1ext", c["T1ext"], np.append(mods[:k], k + 1), mods[k:], mu[k:]),
        ("T2", c["T2"], mods[k : 2 * k], mods[:k], mu[:k]),
    )
    for name, T, xb, m, mu_j in cases:
        uni = np.array(
            [[rng.randrange(int(b)) for b in xb] for _ in range(rows)], np.uint32
        )
        compare(uni, T, m, mu_j, f"{name} uniform")
        top = np.broadcast_to(xb - 1, (rows, len(xb))).astype(np.uint32)
        compare(top, T, m, mu_j, f"{name} maximal")
    x = np.full((1, k + 1), 16380, np.uint32)
    x[0, -1] = 16379
    T = np.full((k + 1, 1), 16380, np.uint32)
    m = np.array([16381], np.uint32)
    for mu_j in (rns._barrett_consts(m), rns.inv_f32(m)):
        compare(x, T, m, mu_j, f"16380-plane input ({mu_j.dtype})")
    return k


def phase_exactness(contexts, seed: int):
    """contexts: {name: device_consts dict}."""
    rng = random.Random(seed)
    ks = {}
    for name, conv in contexts.items():
        ks[name] = check_matmul_mod(conv, rng)
    bad = rns_f32_dots(next(iter(contexts.values())))
    if bad:
        raise AssertionError(f"f32 x f32 dots without HIGHEST: {bad}")
    log(f"[exactness] matmul_mod exact at k={ks}; no f32 dot in ops/rns.py: ok")


def engine_contexts(label, key):
    """The RNS contexts a key's engines build: n^2 (public and RAW) and
    the stacked p^2 / q^2 pair of CRT decrypt."""
    crt = key.priv_key._engine.rns_crt
    return {
        f"{label} n^2": key.pub_key._engine.rns,
        f"{label} p^2": {k: v[0] for k, v in crt.items()},
        f"{label} q^2": {k: v[1] for k, v in crt.items()},
    }


# ---------------------------------------------------------------------------
# phase 3: ISO/IEC 18033-6 known answers
# ---------------------------------------------------------------------------


def phase_kat(ptpu):
    from iso_vectors import (
        ISO_C1, ISO_C1C2, ISO_C2, ISO_M1, ISO_M1M2, ISO_M2, ISO_P, ISO_Q,
        ISO_R0, ISO_R1,
    )

    n = ISO_P * ISO_Q
    pk = ptpu.PublicKey(n, n.bit_length())
    sk = ptpu.PrivateKey(pk, ISO_P, ISO_Q)
    pk.set_random([ISO_R0, ISO_R1])
    ct = pk.encrypt(ptpu.PlainText([ISO_M1, ISO_M2]))
    check(ct.texts == [ISO_C1, ISO_C2], "KAT ciphertexts differ")
    check(sk.decrypt(ct).texts == [ISO_M1, ISO_M2], "KAT decrypt differs")
    s = ptpu.CipherText(pk, ISO_C1) + ptpu.CipherText(pk, ISO_C2)
    check(s.texts == [ISO_C1C2], "KAT CT+CT differs")
    check(sk.decrypt(s).texts == [ISO_M1M2], "KAT sum decrypt differs")
    log(f"[kat] ISO/IEC 18033-6 vectors bit-exact (backend "
        f"{pk._engine.backend}): ok")


# ---------------------------------------------------------------------------
# phases 4-5: the public API at real widths
# ---------------------------------------------------------------------------


def timed(times, label, fn):
    """Run ``fn`` twice, each ending in a device sync; record the first
    call (compilation included) and the warm second call."""
    t = time.perf_counter()
    out = fn()
    out.block_until_ready()
    first = time.perf_counter() - t
    t = time.perf_counter()
    out = fn()
    out.block_until_ready()
    warm = time.perf_counter() - t
    times[label] = (first, warm)
    return out


def check_pow_rows(ptpu, key, m, rng, rows):
    """``rows`` DJN ciphertexts under set_random, bit-exact against
    (n*m+1) * hs^r mod n^2."""
    pk = key.pub_key
    n, n2 = pk.n, pk.nsquare
    rs = [rng.getrandbits(pk.randbits) for _ in range(rows)]
    pk.set_random(rs)
    ct = pk.encrypt(ptpu.PlainText(m[:rows]))
    want = [(n * mi + 1) * pow(pk.hs, r, n2) % n2 for mi, r in zip(m, rs)]
    check(ct.texts == want, "set_random ciphertexts differ from pow()")
    return ct


def phase_main(ptpu, key, batch, seed, times, rows=POW_ROWS):
    rng = random.Random(seed)
    pk, sk = key.pub_key, key.priv_key
    n = pk.n
    bits = n.bit_length()
    m = [rng.randrange(n) for _ in range(batch)]
    m2 = [rng.randrange(n) for _ in range(batch)]
    pt = [rng.randrange(n) for _ in range(batch)]
    a = rng.randrange(n)
    P = ptpu.PlainText

    ct = timed(times, "encrypt", lambda: pk.encrypt(P(m)))
    d = timed(times, "decrypt", lambda: sk.decrypt(ct))
    check(d.texts == m, "decrypt(encrypt(m)) != m")
    ct2 = pk.encrypt(P(m2))
    s = timed(times, "CT+CT", lambda: ct + ct2)
    check(sk.decrypt(s).texts == [(x + y) % n for x, y in zip(m, m2)], "CT+CT")
    prod = timed(times, "CT*PT", lambda: ct * P(pt))
    check(sk.decrypt(prod).texts == [x * y % n for x, y in zip(m, pt)], "CT*PT")
    sc = timed(times, "CT*PT scalar", lambda: ct * P([a]))
    check(sk.decrypt(sc).texts == [x * a % n for x in m], "CT*PT scalar")
    ob = timed(times, "apply_obfuscator", lambda: pk.apply_obfuscator(ct))
    check(sk.decrypt(ob).texts == m, "apply_obfuscator changed the plaintext")
    check(ob.texts[:rows] != ct.texts[:rows], "obfuscation changed nothing")
    c64 = check_pow_rows(ptpu, key, m, rng, rows)

    # normal (non-DJN) encryption with the same key material, and RAW
    # decryption, on a small batch
    pkn = ptpu.PublicKey(n, bits)
    skn = ptpu.PrivateKey(pkn, sk.p, sk.q)
    rn = [rng.randrange(1, n) for _ in range(rows)]
    pkn.set_random(rn)
    cn = pkn.encrypt(P(m[:rows]))
    n2 = pk.nsquare
    want = [(n * x + 1) * pow(r, n, n2) % n2 for x, r in zip(m, rn)]
    check(cn.texts == want, "normal-mode ciphertexts differ from pow()")
    cn = timed(times, "encrypt normal (small)", lambda: pkn.encrypt(P(m[:rows])))
    check(skn.decrypt(cn).texts == m[:rows], "normal-mode roundtrip")
    sk.enable_crt = False
    try:
        raw = timed(times, "decrypt RAW (small)", lambda: sk.decrypt(c64))
        check(raw.texts == m[:rows], "RAW decrypt")
    finally:
        sk.enable_crt = True
    log(f"[main] {bits}-bit DJN batch {batch}: encrypt/decrypt, CT+CT, CT*PT "
        f"(per-row, scalar), apply_obfuscator exact; {rows} rows == pow(); "
        f"normal encrypt + RAW decrypt ({rows} rows) exact: ok")
    return ct


def phase_batches(ptpu, key, batches, seed, pool=16):
    """CRT decrypt of (n*m+1) * hs^r mod n^2, made on the host with ``pool``
    obfuscators, at each batch size in ``batches``: each size compiles its
    own decrypt program."""
    rng = random.Random(seed)
    pk, sk = key.pub_key, key.priv_key
    n, n2 = pk.n, pk.nsquare
    obf = [pow(pk.hs, rng.getrandbits(pk.randbits), n2) for _ in range(pool)]
    for b in batches:
        m = [rng.randrange(n) for _ in range(b)]
        c = [(n * x + 1) * obf[i % pool] % n2 for i, x in enumerate(m)]
        got = sk.decrypt(ptpu.CipherText(pk, c)).texts
        bad = sum(g != x for g, x in zip(got, m))
        check(bad == 0, f"CRT decrypt at batch {b}: {bad} of {b} rows wrong")
    log(f"[batches] {n.bit_length()}-bit CRT decrypt exact at batches "
        f"{list(batches)}: ok")


def phase_wide(ptpu, key, batch, seed, times, rows=POW_ROWS):
    rng = random.Random(seed)
    pk, sk = key.pub_key, key.priv_key
    m = [rng.randrange(pk.n) for _ in range(batch)]
    bits = pk.n.bit_length()
    ct = timed(times, f"encrypt {bits}", lambda: pk.encrypt(ptpu.PlainText(m)))
    d = timed(times, f"decrypt {bits}", lambda: sk.decrypt(ct))
    check(d.texts == m, f"{bits}-bit roundtrip")
    check_pow_rows(ptpu, key, m, rng, rows)
    log(f"[wide] {bits}-bit DJN batch {batch}: roundtrip exact; {rows} rows "
        f"== pow(): ok")


# ---------------------------------------------------------------------------
# phase 6: information lines
# ---------------------------------------------------------------------------


def memory_analysis(key, ct):
    """Compiled memory analysis of the encrypt and CRT-decrypt programs."""
    from pailliercryptolib_tpu.ops import paillier_ops as pops
    from pailliercryptolib_tpu.utils.rng import DeviceSeed

    pub, priv = key.pub_key._engine, key.priv_key._engine
    planes, _ = pub.fixedbase
    m_a = pub._upload_narrow(pub._pad([1] * ct.size, 0))
    enc = pops.encrypt_fb_fused_rng_stage.lower(
        planes, pub._seed_rows(DeviceSeed()), pub.fb_mask, m_a, pub.n_limbs,
        pub.rns, pub.n2_args[0],
    )
    ct_a, _ = priv._ct_operand(ct, 2 * priv.Lp2)
    dec = pops.decrypt_crt_rns_op.lower(
        ct_a, priv.sq_n, priv.exp_wins, priv.hensel, priv.hfun, priv.pq_n,
        priv.pq_n0inv, priv.pq_r2, priv.pinv_q, priv.p_limbs, priv.rns_crt,
    )
    out = {}
    for name, lowered in (("encrypt", enc), ("decrypt", dec)):
        ma = lowered.compile().memory_analysis()
        out[name] = {
            f: getattr(ma, f, None)
            for f in ("argument_size_in_bytes", "output_size_in_bytes",
                      "temp_size_in_bytes", "generated_code_size_in_bytes")
        }
    return out


def phase_info(times, mem, device):
    for label, (first, warm) in times.items():
        log(f"[info] {label}: first call {first:.3f} s (compile included), "
            f"warm {warm * 1e3:.3f} ms")
    for name, stats in mem.items():
        log(f"[info] memory_analysis {name}: {json.dumps(stats)}")
    stats = device.memory_stats() or {}
    log(f"[info] peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


def trace(ptpu, key, batch, seed, out_dir):
    """jax.profiler trace of a warm encrypt + decrypt (two rounds)."""
    import jax

    rng = random.Random(seed)
    m = [rng.randrange(key.pub_key.n) for _ in range(batch)]
    pt = ptpu.PlainText(m)
    key.priv_key.decrypt(key.pub_key.encrypt(pt)).block_until_ready()
    jax.profiler.start_trace(out_dir)
    try:
        for _ in range(2):
            with jax.profiler.TraceAnnotation("encrypt"):
                ct = key.pub_key.encrypt(pt)
                ct.block_until_ready()
            with jax.profiler.TraceAnnotation("decrypt"):
                key.priv_key.decrypt(ct).block_until_ready()
    finally:
        jax.profiler.stop_trace()
    log(f"[trace] warm {key.pub_key.n.bit_length()}-bit encrypt + decrypt "
        f"x2 at batch {batch}: {out_dir}")


# ---------------------------------------------------------------------------
# --four: the sharded path against one device
# ---------------------------------------------------------------------------


def phase_four(ptpu, key, batch, ndev, seed, times):
    """encrypt -> CT+CT -> CT*PT -> decrypt with the batch sharded over
    ``ndev`` devices (initialize_context mesh), against the same key on
    one device in this process: bit-exact under set_random, and a
    roundtrip under the device RNG (whose seed rows differ per shard)."""
    rng = random.Random(seed)
    n = key.pub_key.n
    m = [rng.randrange(n) for _ in range(batch)]
    pt = [rng.randrange(n) for _ in range(batch)]
    rs = [rng.getrandbits(key.pub_key.randbits) for _ in range(batch)]
    P = ptpu.PlainText
    want = [2 * x * y % n for x, y in zip(m, pt)]

    def pipeline(pk, sk, label):
        pk.set_random(rs)
        ct = pk.encrypt(P(m))
        prod = (ct + ct) * P(pt)
        d = sk.decrypt(prod)
        check(d.texts == want, f"{label}: decrypt((ct+ct)*pt) != 2*m*pt")
        return [ct.texts, (ct + ct).texts, prod.texts]

    one = pipeline(key.pub_key, key.priv_key, "1 device")
    ctx = ptpu.initialize_context(mesh_devices=ndev)
    try:
        pk = ptpu.PublicKey(n, key.pub_key.bits, hs=key.pub_key.hs,
                            randbits=key.pub_key.randbits)
        sk = ptpu.PrivateKey(pk, key.priv_key.p, key.priv_key.q)
        check(pk._engine.mesh is ctx.mesh and ctx.mesh.devices.size == ndev)
        many = pipeline(pk, sk, f"{ndev} devices")
        check(many == one, f"{ndev}-device results differ from 1 device")
        ct = timed(times, f"encrypt x{ndev}", lambda: pk.encrypt(P(m)))
        spec = ct.device_payload().arr.sharding.spec
        check(spec[0] == "batch", f"ciphertext not batch-sharded: {spec}")
        d = timed(times, f"decrypt x{ndev}", lambda: sk.decrypt(ct))
        check(d.texts == m, f"{ndev}-device device-RNG roundtrip")
        prod = timed(times, f"(CT+CT)*PT x{ndev}", lambda: (ct + ct) * P(pt))
        check(sk.decrypt(prod).texts == want, "device-RNG pipeline")
    finally:
        ptpu.terminate_context()
    log(f"[four] {n.bit_length()}-bit batch {batch} on {ndev} devices: "
        f"encrypt/CT+CT/CT*PT bit-exact with 1 device under set_random; "
        f"device-RNG pipeline exact: ok")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-device sharded path and its "
                         "1-device comparison")
    ap.add_argument("--trace", metavar="DIR",
                    help="also trace a warm 2048-bit encrypt + decrypt")
    args = ap.parse_args(argv)

    ptpu = import_package()
    from pailliercryptolib_tpu.utils.config import enable_compile_cache

    log(f"[setup] compile cache: {enable_compile_cache()}")
    import jax

    device = phase_device(4 if args.four else 1)
    times = {}
    t = time.perf_counter()
    key = ptpu.generate_keypair(MAIN_BITS, enable_DJN=True)
    log(f"[setup] keygen {MAIN_BITS}: {time.perf_counter() - t:.1f} s")
    if args.four:
        phase_four(ptpu, key, MAIN_BATCH, 4, SEED, times)
        phase_info(times, {}, device)
    else:
        t = time.perf_counter()
        wide = ptpu.generate_keypair(WIDE_BITS, enable_DJN=True)
        log(f"[setup] keygen {WIDE_BITS}: {time.perf_counter() - t:.1f} s")
        contexts = {**engine_contexts(MAIN_BITS, key),
                    **engine_contexts(WIDE_BITS, wide)}
        phase_exactness(contexts, SEED)
        phase_kat(ptpu)
        ct = phase_main(ptpu, key, MAIN_BATCH, SEED, times)
        phase_batches(ptpu, key, DECRYPT_BATCHES, SEED)
        phase_wide(ptpu, wide, WIDE_BATCH, SEED, times)
        mem = memory_analysis(key, ct.device_payload())
        phase_info(times, mem, device)
        if args.trace:
            trace(ptpu, key, MAIN_BATCH, SEED, args.trace)
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
