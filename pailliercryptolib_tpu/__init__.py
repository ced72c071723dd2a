"""pailliercryptolib_tpu — a batched Paillier cryptosystem framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
intel/pailliercryptolib (IPCL): Paillier keygen, encryption (normal + DJN),
CRT decryption, homomorphic add / scalar-multiply, serialization — with the
single hot primitive (batched modular exponentiation) implemented as RNS
Montgomery arithmetic whose base extensions are exact digit-plane matrix
products, instead of AVX512-IFMA/QAT offload.

Public API (mirrors ipcl/include/ipcl/ipcl.hpp):

    >>> import pailliercryptolib_tpu as ptpu
    >>> key = ptpu.generate_keypair(2048, enable_DJN=True)
    >>> ct = key.pub_key.encrypt(ptpu.PlainText([1, 2, 3]))
    >>> pt = key.priv_key.decrypt(ct + ct)
"""

from .models.keygen import generate_keypair, get_prime
from .ops.api import modexp
from .models.keys import KeyPair, PrivateKey, PublicKey
from .models.texts import BaseText, CipherText, PlainText
from .ops.dispatch import (
    HybridMode,
    get_hybrid_mode,
    get_hybrid_ratio,
    set_hybrid_mode,
    set_hybrid_off,
    set_hybrid_ratio,
)
from .parallel.context import (
    get_context,
    initialize_context,
    terminate_context,
)

__version__ = "0.1.0"

__all__ = [
    "BaseText",
    "CipherText",
    "KeyPair",
    "PlainText",
    "PrivateKey",
    "PublicKey",
    "generate_keypair",
    "get_prime",
    "modexp",
    "HybridMode",
    "get_hybrid_mode",
    "get_hybrid_ratio",
    "set_hybrid_mode",
    "set_hybrid_off",
    "set_hybrid_ratio",
    "get_context",
    "initialize_context",
    "terminate_context",
    "__version__",
]
