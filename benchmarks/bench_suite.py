#!/usr/bin/env python
"""Full benchmark suite mirroring the reference harness
(benchmark/bench_cryptography.cpp + bench_ops.cpp): keygen, encrypt,
decrypt, CT+CT, CT+PT, CT*PT across the reference batch sizes.

Usage:  python benchmarks/bench_suite.py [--bits 2048] [--batches 16,256,2048]
        [--cpu]   # harness smoke on the CPU (CI); lines say "platform": "cpu"
Prints one JSON line per (op, batch), each stamped with the device (JAX
platform, device kind and count, and the card's name and power limit).
Without ``--cpu`` it stops when JAX finds no GPU.

Method: best of ``--blocks`` timing blocks of ``--iters`` pipelined calls,
each block ending in a device sync — the same method as bench.py.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import random  # noqa: E402

import pailliercryptolib_tpu as ptpu  # noqa: E402
from pailliercryptolib_tpu.utils.config import enable_compile_cache  # noqa: E402
from pailliercryptolib_tpu.utils.devinfo import device_stamp  # noqa: E402

DEFAULT_BATCHES = [16, 64, 128, 256, 512, 1024, 2048]  # bench_cryptography.cpp:10-19


def timed(fn, iters=3, blocks=3):
    """Best per-call seconds over ``blocks`` blocks of ``iters`` pipelined
    calls (same method as bench.py's headline)."""

    def sync(x):
        if hasattr(x, "block_until_ready"):
            x.block_until_ready()
        return x

    sync(fn())  # warm / compile
    best = float("inf")
    for _ in range(blocks):
        t = time.time()
        for _ in range(iters):
            out = fn()
        sync(out)
        best = min(best, (time.time() - t) / iters)
    return best, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=2048)
    ap.add_argument("--batches", type=str, default=None)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="allow the CPU (harness smoke; not a measurement)")
    args = ap.parse_args()
    enable_compile_cache()
    stamp = device_stamp(allow_cpu=args.cpu)
    batches = (
        [int(b) for b in args.batches.split(",")] if args.batches else DEFAULT_BATCHES
    )
    rng = random.Random(1)

    print(json.dumps({
        "meta": "bench_suite",
        "method": f"best of {args.blocks} blocks x {args.iters} "
                  "pipelined iters, device-synced per block",
        "bits": args.bits,
        "date": time.strftime("%Y-%m-%d"),
        **stamp,
    }), flush=True)

    def row(**kw):
        print(json.dumps({**kw, **stamp}), flush=True)

    t = time.time()
    key = ptpu.generate_keypair(args.bits, enable_DJN=True)
    row(op="keygen", bits=args.bits, ms=round((time.time() - t) * 1e3, 3))

    for B in batches:
        vals = [rng.getrandbits(32) for _ in range(B)]
        pt = ptpu.PlainText(vals)
        three = ptpu.PlainText([3] * B)

        dt, ct = timed(lambda: key.pub_key.encrypt(pt), args.iters, args.blocks)
        row(op="encrypt", batch=B, ms=round(dt * 1e3, 3), per_s=round(B / dt))
        dt, _ = timed(lambda: key.priv_key.decrypt(ct), args.iters, args.blocks)
        row(op="decrypt", batch=B, ms=round(dt * 1e3, 3), per_s=round(B / dt))
        dt, _ = timed(lambda: ct + ct, args.iters, args.blocks)
        row(op="add_ctct", batch=B, ms=round(dt * 1e3, 3), per_s=round(B / dt))
        dt, _ = timed(lambda: ct + pt, args.iters, args.blocks)
        row(op="add_ctpt", batch=B, ms=round(dt * 1e3, 3), per_s=round(B / dt))
        dt, _ = timed(lambda: ct * three, args.iters, args.blocks)
        row(op="mul_ctpt", batch=B, ms=round(dt * 1e3, 3), per_s=round(B / dt))


if __name__ == "__main__":
    main()
