"""Public batched-modexp API on Python ints (the ipcl::modExp equivalent).

Mirrors the reference's top-level dispatch function
(`ipcl::modExp(vector<BigNumber>, vector<BigNumber>, vector<BigNumber>)`,
ipcl/mod_exp.hpp:72-83): accepts scalars or equal-length lists, supports a
*vector of moduli* by grouping elements that share a modulus into one
batched device call each (the reference pads chunks of 8 to the widest
operand instead, ipcl/mod_exp.cpp:480-516).

Moduli must be odd (a Montgomery-arithmetic requirement, as in the
reference's ippsMontExp backend).  One-shot calls run the CIOS
exponentiation (ops/montgomery.py): building an RNS context per modulus
would cost more than it saves.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from .limbs import ints_to_limbs, ints_to_windows, limbs_to_ints, num_windows
from .montgomery import MontConstants, mont_exp

IntOrList = Union[int, Sequence[int]]


@functools.lru_cache(maxsize=64)
def _mont_cache(modulus: int) -> MontConstants:
    return MontConstants.create(modulus)


_modexp_jit = jax.jit(mont_exp)


def _modexp_group(bases: List[int], exps: List[int], m: int):
    ctx = _mont_cache(m)
    L = ctx.num_limbs
    target = 1 << max(0, (len(bases) - 1).bit_length())
    bases = bases + [1] * (target - len(bases))
    exps = exps + [0] * (target - len(exps))
    ebits = max(1, max(e.bit_length() for e in exps))
    nw = max(8, -(-num_windows(ebits) // 8) * 8)
    base_a = jnp.asarray(ints_to_limbs([b % m for b in bases], L))
    wins = jnp.asarray(ints_to_windows(exps, nw * 4))
    n, n0inv, r2, one = ctx.as_device_args()
    out = _modexp_jit(base_a, wins, n, n0inv, r2, one)
    return limbs_to_ints(np.asarray(out))


def modexp(
    base: IntOrList, exp: IntOrList, mod: IntOrList
) -> Union[int, List[int]]:
    """base^exp mod mod, elementwise over equal-length vectors (or scalars).

    Per-element moduli are supported: elements are grouped by modulus value
    and each unique modulus runs as one batched device call.
    """
    scalar = isinstance(base, int) and isinstance(exp, int) and isinstance(mod, int)
    bases = [base] if isinstance(base, int) else [int(v) for v in base]
    size = len(bases)
    exps = [exp] * size if isinstance(exp, int) else [int(v) for v in exp]
    mods = [mod] * size if isinstance(mod, int) else [int(v) for v in mod]
    if not (len(exps) == size and len(mods) == size):
        raise ValueError("modExp: input vector sizes mismatch")
    for m in mods:
        if m <= 0 or m % 2 == 0:
            raise ValueError("modExp: moduli must be positive odd integers")

    groups = {}
    for i, m in enumerate(mods):
        groups.setdefault(m, []).append(i)

    out: List[int] = [0] * size
    for m, idxs in groups.items():
        res = _modexp_group([bases[i] for i in idxs], [exps[i] for i in idxs],
                            m)
        for j, i in enumerate(idxs):
            out[i] = res[j]
    return out[0] if scalar else out
