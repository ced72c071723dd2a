"""Hybrid-ratio sweep: measure the RNS/CIOS batch split, mirroring the
reference's bench_hybrid (benchmark/bench_hybrid.cpp:66-222), which sweeps
the QAT ratio 0..100% for modexp/encrypt/decrypt/mul and from which its
OPTIMAL ratios (ipcl/include/ipcl/utils/common.hpp:18-23) were derived.

Here the primary backend is RNS and the secondary is the CIOS ("xla")
pipeline (ops/dispatch.py HybridMode); ratio r routes floor(r*B) rows to
RNS and the rest to CIOS, concurrently via JAX async dispatch.  This is
the measurement behind ops/dispatch.OPTIMAL_RATIOS (policy 1.0 until it
runs on the H100).  Runs on a GPU only; every line carries the device
stamp.

Usage: python benchmarks/bench_hybrid.py [--bits 1024] [--batches 16,256]
       [--ratios 0,0.5,0.9,1] [--iters 3]
Prints one JSON line per (op, batch, ratio).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import random  # noqa: E402

import pailliercryptolib_tpu as ptpu  # noqa: E402
from pailliercryptolib_tpu.ops import dispatch  # noqa: E402
from pailliercryptolib_tpu.utils.config import enable_compile_cache  # noqa: E402
from pailliercryptolib_tpu.utils.devinfo import device_stamp  # noqa: E402


def log(m):
    print(m, file=sys.stderr, flush=True)


def timed(fn, iters):
    out = fn()
    out.block_until_ready()
    t0 = time.time()
    for _ in range(iters):
        out = fn()
    out.block_until_ready()
    return (time.time() - t0) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=1024)
    ap.add_argument("--batches", type=str, default="16,256")
    ap.add_argument("--ratios", type=str, default="0,0.5,0.9,1")
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    enable_compile_cache()
    stamp = device_stamp()
    batches = [int(b) for b in args.batches.split(",")]
    ratios = [float(r) for r in args.ratios.split(",")]
    rng = random.Random(5)

    key = ptpu.generate_keypair(args.bits, enable_DJN=True)
    log(f"key {args.bits}b, batches {batches}, ratios {ratios}")

    for B in batches:
        vals = [rng.getrandbits(32) for _ in range(B)]
        pt = ptpu.PlainText(vals)
        three = ptpu.PlainText([3] * B)
        dispatch.set_hybrid_off()
        ct = key.pub_key.encrypt(pt)
        for r in ratios:
            dispatch.set_hybrid_ratio(r)
            for op, fn in (
                ("encrypt", lambda: key.pub_key.encrypt(pt)),
                ("decrypt", lambda: key.priv_key.decrypt(ct)),
                ("mul_ctpt", lambda: ct * three),
            ):
                dt = timed(fn, args.iters)
                row = {
                    "op": op, "bits": args.bits, "batch": B, "ratio": r,
                    "ms": round(dt * 1e3, 3), "per_s": round(B / dt),
                    **stamp,
                }
                print(json.dumps(row), flush=True)
                log(f"{op:9s} B={B:5d} r={r:4.2f}  {dt*1e3:9.2f} ms")
        dispatch.set_hybrid_off()


if __name__ == "__main__":
    main()
