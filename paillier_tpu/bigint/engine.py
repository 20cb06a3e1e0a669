"""Unified modexp-engine interface and selection.

Engines expose the same duck type so the crypto layers stay engine
agnostic:

    from_limbs(x)  : uint32 limb tensor [..., L] -> residue tensor
    to_limbs(x)    : residues -> uint32 limb tensor of the exact value
    pow(x, d, w)   : x^e mod N on residues (digits MSB-first base-2^w)
    mul(x, y)      : plain modular product on residues
    mont_mul(x, y) : Montgomery product x*y*M^-1 (for product trees)
    spec.M / spec.encode : CRT scale and host-side residue encoding

Selection: ``rns2`` (int8 Cox-Rower; bigint/rns2.py) is the default
everywhere — the same XLA program on every backend.  ``rns`` (bf16
Cox-Rower, bigint/rns.py) is kept as the v1 fallback behind
PAILLIER_TPU_ENGINE=rns.  The limb-Montgomery path
(bigint/montgomery.py) is selected by the callers directly for small
moduli where RNS setup cost dominates.
"""

from __future__ import annotations

import os

import jax.numpy as jnp


def default_engine_kind() -> str:
    from ..config import engine_kind
    return engine_kind()


class _V1Engine:
    """Adapter giving the v1 (bf16 Cox-Rower) engine the unified API."""

    def __init__(self, n_modulus: int, n_limbs: int):
        from .limbmm import BarrettPlan
        from .rns import RnsConverter, RnsEngine
        self._eng = RnsEngine(n_modulus)
        self._conv = RnsConverter(self._eng, n_limbs)
        self.spec = self._eng.spec
        self.barrett = BarrettPlan.build(n_modulus)

    def from_limbs(self, x):
        return self._conv.from_limbs(x)

    def to_limbs(self, x):
        return self._conv.to_limbs(x)

    def to_limbs_mod(self, x):
        from .limbmm import barrett_small
        return barrett_small(self._conv.to_limbs(x), self.barrett)

    def pow(self, x, digits, window: int = 4):
        from .rns import _rns_pow
        e = self._eng
        return _rns_pow(e.ctx, e.m2_rns, e.one_rns, e.mmodn_rns,
                        x, digits, window)

    def pow_shared(self, x, e_int: int, window: int = 4):
        """Shared-exponent pow (digit-ladder fallback for the v1 engine)."""
        from . import montgomery as mont
        nd = mont.n_digits_for_bits(max(1, e_int.bit_length()), window)
        return self.pow(x, jnp.asarray(mont.exp_digits(e_int, window, nd)),
                        window)

    def mont_mul(self, x, y):
        return self._eng.mont_mul(x, y)

    def mul(self, x, y):
        from .rns import rns_mont_mul
        t = rns_mont_mul(self._eng.ctx, x, y)
        return rns_mont_mul(self._eng.ctx, t,
                            jnp.broadcast_to(self._eng.m2_rns, t.shape))


def make_engine(n_modulus: int, n_limbs: int, kind: str | None = None):
    """Build a modexp engine for an odd modulus.  kind: rns2 | rns."""
    kind = kind or default_engine_kind()
    if kind == "rns2":
        from .rns2 import Rns2Engine
        return Rns2Engine(n_modulus, n_limbs)
    if kind == "rns":
        return _V1Engine(n_modulus, n_limbs)
    raise ValueError(f"unknown engine kind {kind!r}")
