"""Two-process jax.distributed driver (launched by test_multihost.py).

Each process owns 4 virtual CPU devices; the global mesh spans 8 devices
across both processes.  The whole flow goes through the PUBLIC package API:
initialize_context(distributed=True) -> PublicKey.encrypt ->
PrivateKey.decrypt, with deterministic keys and injected obfuscator randoms
so the sharded ciphertext can be checked bit-exactly against host pow() —
i.e. exact equality with what a single process computes.

This is the bring-up test the reference cannot have (no distributed
backend, SURVEY.md §2.5); the analog being replaced is heqat's device
runtime bring-up (module/heqat/heqat/context.c:131-260).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pailliercryptolib_tpu as ptpu  # noqa: E402
from pailliercryptolib_tpu.parallel import context as pctx  # noqa: E402

ctx = pctx.initialize_context(
    distributed=True,
    coordinator_address=f"localhost:{port}",
    num_processes=nproc,
    process_id=pid,
)
assert len(jax.devices()) == 4 * nproc, jax.devices()
assert ctx.mesh.devices.size == 4 * nproc

# deterministic DJN key from fixed primes (identical on every process)
P_ = 232599217864819576116843431118455220359  # 128-bit primes
Q_ = 336405090652084295268975770772500216531
n = P_ * Q_
n2 = n * n
h = (-(2 * 2)) % n  # DJN h with rmod = 2
hs = pow(h, n, n2)
pk = ptpu.PublicKey(n, n.bit_length(), hs=hs, randbits=n.bit_length() // 2)
sk = ptpu.PrivateKey(pk, P_, Q_)
assert pk._engine.mesh is ctx.mesh
assert pk._engine.backend == "rns"  # the default on every platform

B = 16
vals = [1000003 * (i + 1) for i in range(B)]
rs = [(0x9E3779B97F4A7C15 * (i + 1)) % (1 << 120) for i in range(B)]
pk.set_random(list(rs))
ct = pk.encrypt(ptpu.PlainText(vals))

# the ciphertext batch is globally sharded across both processes
arr = ct.device_payload().arr
assert not arr.is_fully_addressable, "expected a cross-process global array"

# bit-exact vs host math == exact equality with the single-process result
expect = [(n * m + 1) * pow(hs, r, n2) % n2 for m, r in zip(vals, rs)]
assert ct.texts == expect, "sharded ciphertext != host pow() reference"

dt = sk.decrypt(ct)
assert dt.texts == vals, "roundtrip mismatch"

# homomorphic op across the global mesh
s = ct + ct
assert sk.decrypt(s).texts == [2 * v for v in vals]

print(f"MULTIHOST_OK pid={pid}", flush=True)
