"""Randomness for key material and obfuscators.

The reference selects RDSEED -> RDRAND -> IPP PRNG at runtime
(ipcl/utils/common.cpp:18-77, util.hpp:46-74).  Here the split is:

* **key material**: the OS CSPRNG (``secrets`` / ``os.urandom``) — there
  is no on-device TRNG to prefer, and these values are secret.
* **fresh obfuscators (hot path)**: a per-call OS-CSPRNG key+nonce
  expanded ON DEVICE by an RFC 8439 ChaCha20 keystream
  (:class:`DeviceSeed`, ops/paillier_ops._chacha20_blocks) — a vetted
  cryptographic DRBG in the role of the reference's ippsPRNGen DRBG
  seeded from rdseed (common.cpp:52-77).  The host uploads a 44-byte
  seed per call instead of the full obfuscator byte matrix
  (~256 KB/2048-batch).  ``PAILLIER_TPU_HOST_RNG=1`` restores the
  bytes-direct path.
* **deterministic test vectors**: explicit injection via
  ``PublicKey.set_random`` (the analog of the reference's ``setRandom`` hook,
  ipcl/pub_key.cpp:92-95), which makes encryption a pure function for the
  ISO/IEC 18033-6 compliance tests.
"""

from __future__ import annotations

import os
import secrets
from typing import List


class DeviceSeed:
    """A per-call OS-entropy ChaCha20 key+nonce (uint32[11]: 256-bit key,
    96-bit nonce) for on-device obfuscator expansion.

    Engines evaluate an RFC 8439 ChaCha20 keystream on the device
    (ops/paillier_ops._chacha20_blocks) — a vetted CSPRNG construction,
    deliberately NOT jax.random (whose generators are documented as
    non-cryptographic).  Sharded meshes expand on device too, one seed
    row per shard (models/engine._seed_rows).  Paths that cannot expand
    on device (hybrid batch splits, the CIOS backend) call
    :meth:`materialize` for an equivalent fresh host draw instead."""

    __slots__ = ("data",)

    def __init__(self):
        import numpy as np

        self.data = np.frombuffer(os.urandom(44), np.uint32).copy()

    def materialize(self, count: int, nbits: int):
        return batch_random_bytes(count, nbits)


def use_device_rng() -> bool:
    """Whether fresh obfuscators expand on device (default; see module
    docstring)."""
    return os.environ.get("PAILLIER_TPU_HOST_RNG") != "1"


def random_bits(nbits: int) -> int:
    """Uniform integer in [0, 2**nbits)."""
    return secrets.randbits(nbits)


def batch_random_bits(count: int, nbits: int) -> List[int]:
    """``count`` independent uniform integers in [0, 2**nbits).

    Bulk-reads the OS CSPRNG once (cheap even for thousands of 2048-bit
    values) instead of per-element syscalls.
    """
    nbytes = -(-nbits // 8)
    buf = os.urandom(count * nbytes)
    mask = (1 << nbits) - 1
    return [
        int.from_bytes(buf[i * nbytes : (i + 1) * nbytes], "little") & mask
        for i in range(count)
    ]


def batch_random_bytes(count: int, nbits: int):
    """``count`` uniform integers in [0, 2**nbits) as a [count, ceil(nbits/8)]
    uint8 array, LEAST-significant byte first — the exponent wire format of
    the fixed-base exponentiation.  Skips Python-int materialization
    entirely (vs batch_random_bits + re-encoding)."""
    import numpy as np

    nbytes = -(-nbits // 8)
    arr = np.frombuffer(os.urandom(count * nbytes), np.uint8).reshape(
        count, nbytes
    )
    top = nbits % 8
    if top:
        arr = arr.copy()
        arr[:, -1] &= (1 << top) - 1
    return arr
