#!/usr/bin/env python
"""Headline benchmark: batched 2048-bit DJN Paillier encryption per GPU.

Mirrors the reference's BM_Encrypt / BM_Decrypt
(benchmark/bench_cryptography.cpp:73-121) at their largest batch size.
Runs on a GPU only (it stops when JAX finds none) and stamps every JSON
line with the device: JAX platform, device kind and count, and the card's
name and power limit from nvidia-smi.

A parseable JSON line with the same schema is printed (and superseded) at
every milestone, so a run cut short still leaves its latest line:

  1. right after the FIRST encrypt timing block  (decrypt fields null)
  2. after all encrypt timing blocks             (refined value)
  3. after decrypt                               (complete line)

Consumers take the LAST parseable JSON line:

  {"metric": "...", "value": N, "unit": "...", "vs_baseline": null,
   "decrypts_per_s": N|null, "encrypt_ms": N, "decrypt_ms": N|null,
   "encrypt_compile_s": N, "decrypt_compile_s": N|null,
   "partial": true|false, "platform": ..., "device_kind": ...,
   "device_count": N, "card": "<name>, <power limit>"}

Detail lines go to stderr as each stage completes.  Throughput is the
best of ``BLOCKS`` timing blocks of ``ITERS`` pipelined calls, each block
ending in a device sync (block_until_ready).
"""

import json
import random
import sys
import time

import pailliercryptolib_tpu as ptpu
from pailliercryptolib_tpu.utils.config import enable_compile_cache
from pailliercryptolib_tpu.utils.devinfo import device_stamp

KEY_BITS = 2048
BATCH = 2048
ITERS = 20  # deep pipeline: the device queue hides host codec + dispatch
BLOCKS = 4  # timing blocks; report the best


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def emit(stamp, enc_dt, enc_compile, dec_dt=None, dec_compile=None,
         partial=True):
    """Print the driver-parseable metric line (flushed immediately)."""
    print(
        json.dumps(
            {
                "metric": "paillier_2048_djn_encrypts_per_s_per_chip",
                "value": round(BATCH / enc_dt, 1),
                "unit": "encrypts/s",
                "vs_baseline": None,  # no H100 target set yet
                "decrypts_per_s": (
                    round(BATCH / dec_dt, 1) if dec_dt else None
                ),
                "encrypt_ms": round(enc_dt * 1000, 2),
                "decrypt_ms": round(dec_dt * 1000, 2) if dec_dt else None,
                "encrypt_compile_s": round(enc_compile, 1),
                "decrypt_compile_s": (
                    round(dec_compile, 1) if dec_compile is not None else None
                ),
                "partial": partial,
                **stamp,
            }
        ),
        flush=True,
    )


def _one_block(fn, sync):
    t = time.perf_counter()
    out = None
    for _ in range(ITERS):
        out = fn()
    sync(out)
    return (time.perf_counter() - t) / ITERS


def _best_block(fn, sync, nblocks, first_cb=None):
    """Best per-iteration seconds over ``nblocks`` blocks of ITERS calls.

    ``first_cb`` runs after the first block (used to emit a partial
    metric line as early as possible)."""
    best = float("inf")
    per = []
    for i in range(nblocks):
        dt = _one_block(fn, sync)
        per.append(dt)
        best = min(best, dt)
        if i == 0 and first_cb is not None:
            first_cb(dt)
    log(f"  blocks (ms): {[round(p * 1000, 3) for p in per]}")
    return best


def main():
    enable_compile_cache()
    stamp = device_stamp()
    log(f"device: {stamp}")
    rng = random.Random(0xBEEF)
    t = time.perf_counter()
    key = ptpu.generate_keypair(KEY_BITS, enable_DJN=True)
    log(f"keygen({KEY_BITS}, DJN): {time.perf_counter() - t:.1f}s")

    vals = [rng.getrandbits(32) for _ in range(BATCH)]
    pt = ptpu.PlainText(vals)

    t = time.perf_counter()
    ct = key.pub_key.encrypt(pt)
    ct.block_until_ready()
    enc_compile = time.perf_counter() - t
    log(f"encrypt first (compile): {enc_compile:.1f}s")

    # Pipelined throughput: ciphertexts are device-resident (no host
    # round-trip per batch); the device executes dispatches in order, so
    # syncing the last batch bounds the wall time of all of them.
    enc_dt = _best_block(
        lambda: key.pub_key.encrypt(pt),
        lambda ct: ct.block_until_ready(),
        BLOCKS,
        first_cb=lambda dt: emit(stamp, dt, enc_compile),
    )
    log(f"encrypt batch={BATCH}: {enc_dt * 1000:.3f} ms -> "
        f"{BATCH / enc_dt:.0f}/s")
    emit(stamp, enc_dt, enc_compile)

    t = time.perf_counter()
    dt_pt = key.priv_key.decrypt(ct)
    dt_pt.block_until_ready()
    dec_compile = time.perf_counter() - t
    log(f"decrypt first (compile): {dec_compile:.1f}s")
    dec_dt = _best_block(
        lambda: key.priv_key.decrypt(ct),
        lambda p: p.block_until_ready(),
        BLOCKS,
        first_cb=lambda dt: emit(stamp, enc_dt, enc_compile, dt, dec_compile),
    )
    log(f"decrypt batch={BATCH}: {dec_dt * 1000:.3f} ms -> "
        f"{BATCH / dec_dt:.0f}/s")

    dt_pt = key.priv_key.decrypt(ct)
    assert dt_pt.texts == vals, "roundtrip mismatch!"
    log("roundtrip verified")

    emit(stamp, enc_dt, enc_compile, dec_dt, dec_compile, partial=False)


if __name__ == "__main__":
    main()
