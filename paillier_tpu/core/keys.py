"""Key material and ciphertext containers.

Host-side key objects hold Python-int values (control plane); the derived
:class:`DeviceKey` holds the Montgomery contexts and precomputed constants
used by the batched device kernels.

Reference parity: PublicKey/SecretKey/Ciphertext structure follows
paillier.go:46-69; level handling follows paillier.go:403-414.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..bigint import host
from ..bigint.montgomery import MontCtx, make_mont_ctx

# Encryption levels (generalized Damgard-Jurik s; reference: paillier.go:15-23)
LEVEL_ONE = 1
LEVEL_TWO = 2
DEFAULT_LEVEL = LEVEL_ONE  # reference: paillier.go:42

# Encryption methods (reference: paillier.go:27-39)
REGULAR = "regular"
ALTERNATIVE = "alternative"
MIXED = "mixed"


@partial(jax.tree_util.register_dataclass,
         data_fields=["c"], meta_fields=["level", "method"])
@dataclass
class Ciphertext:
    """A batch of ciphertexts: uint32 limb tensor [..., L_{s+1}].

    ``level`` is the Damgard-Jurik s (1 or 2): the value lives mod n^(s+1).
    """

    c: jax.Array
    level: int = DEFAULT_LEVEL
    method: str = REGULAR

    @property
    def batch_shape(self):
        return self.c.shape[:-1]


@dataclass
class PublicKey:
    """Paillier public key (reference: paillier.go:46-56).

    n: modulus, g: generator (always n+1), h: random QR generator used by
    alternative encryption, k: 2^(secparam/2) randomness bound.
    """

    n: int
    g: int
    h: int
    k: int
    bits: int

    def __post_init__(self):
        self._device: Optional["DeviceKey"] = None

    @property
    def n2(self) -> int:
        return self.n * self.n

    @property
    def n3(self) -> int:
        return self.n * self.n * self.n

    def modulus_for_level(self, level: int) -> int:
        """n^(s+1) for ciphertexts at level s (reference: paillier.go:403-414)."""
        return self.n2 if level == LEVEL_ONE else self.n3

    def plaintext_modulus(self, level: int) -> int:
        """n^s: the plaintext space at level s."""
        return self.n if level == LEVEL_ONE else self.n2

    def device(self) -> "DeviceKey":
        if self._device is None:
            self._device = DeviceKey.from_public(self)
        return self._device


@dataclass
class SecretKey(PublicKey):
    """Secret key: lambda = phi(n); p, q retained for CRT decryption
    (the reference drops them — keeping the factors enables the CRT fast
    path that BASELINE config #2 requires; reference: paillier.go:292-303
    has no CRT)."""

    lam: int = 0
    p: int = 0
    q: int = 0

    def public(self) -> PublicKey:
        return PublicKey(n=self.n, g=self.g, h=self.h, k=self.k,
                         bits=self.bits)


class DeviceKey:
    """Precomputed device-side contexts for one public key.

    Holds Montgomery contexts for n, n^2, n^3 plus Hensel inverses for the
    exact divisions in decryption's L function.  Built lazily; everything
    here is public-key derived (no secrets).
    """

    def __init__(self, pk: PublicKey):
        self.pk = pk
        L = host.limbs_for_bits(pk.bits)
        self.L = L
        self.ctx_n = make_mont_ctx(pk.n, L)
        self.ctx_n2 = make_mont_ctx(pk.n2, 2 * L)
        # eager: lazy construction inside a jit trace would leak tracers
        self._ctx_n3: Optional[MontCtx] = make_mont_ctx(pk.n3, 3 * L)
        # n^{-1} mod 2^(16*kL): exact-division constants for L(u, n)
        self.n_hensel_L = jnp.asarray(
            host.int_to_limbs(host.hensel_inverse(pk.n, L), L))
        self.n_hensel_2L = jnp.asarray(
            host.int_to_limbs(host.hensel_inverse(pk.n, 2 * L), 2 * L))
        # n limbs at width 2L for shortcut assembly
        self.n_limbs_2L = jnp.asarray(host.int_to_limbs(pk.n, 2 * L))
        # 2^{-1} mod n (for the binomial C(m,2) term at level 2)
        self.inv2_n = jnp.asarray(host.int_to_limbs((pk.n + 1) // 2, L))
        self._hs: dict[int, jax.Array] = {}
        # shared cache of jitted kernels so repeated Encryptor/Decryptor
        # construction reuses compilations (key: kind/level/method/window)
        self.jit_cache: dict = {}
        self._rns: dict = {}

    def rns(self, level: int):
        """Unified RNS engine for modulus n^(s+1), cached.

        Built eagerly (host-side prime search + CRT matrices) — never call
        for the first time inside a jit trace.
        """
        if level not in self._rns:
            from ..bigint.engine import make_engine
            self._rns[level] = make_engine(self.pk.modulus_for_level(level),
                                           self.limbs_for_level(level))
        return self._rns[level]

    def use_rns(self) -> bool:
        """RNS engine pays off for production keys on accelerators.

        Resolution: config.force_rns() (the PAILLIER_TPU_FORCE_RNS=1 env
        override or Config.force_rns) pins the answer; otherwise auto —
        a non-CPU device and key >= 1024 bits.  This is the library's one
        backend decision: every ladder is the same XLA program on every
        backend, so forcing RNS on CPU runs the accelerator path's math,
        which is how tests cover it."""
        from ..config import force_rns
        forced = force_rns()
        if forced is not None:
            return forced
        return jax.devices()[0].platform != "cpu" and self.pk.bits >= 1024

    def pow(self, level: int, base, digits, window: int = 4):
        """Engine-aware modexp mod n^(s+1): RNS on accelerators for
        large keys, limb Montgomery otherwise.

        ``digits``: [D] shared or [..., D] per-element, MSB-first
        base-2^window.  Eager entry point (dispatch happens outside jit).
        """
        from ..bigint import montgomery as mont
        if self.use_rns():
            eng = self.rns(level)
            out = eng.pow(eng.from_limbs(base), digits, window)
            return self._widen(eng.to_limbs_mod(out), level)
        return mont.mont_pow_digits(self.ctx_for_level(level), base,
                                    digits, window)

    def pow_int(self, level: int, base, e: int, window: int = 4):
        """pow with a host-int shared exponent.

        On the RNS engine this routes through the sliding-window
        odd-power ladder (Rns2Engine.pow_shared) — fewer multiplies than
        the fixed-window digit ladder for the same exponent."""
        from ..bigint import montgomery as mont
        import jax.numpy as jnp
        if e == 0:
            return jnp.zeros_like(base).at[..., 0].set(1)
        if self.use_rns():
            eng = self.rns(level)
            if hasattr(eng, "pow_shared"):
                out = eng.pow_shared(eng.from_limbs(base), e)
                return self._widen(eng.to_limbs_mod(out), level)
        nd = mont.n_digits_for_bits(e.bit_length(), window)
        return self.pow(level, base,
                        jnp.asarray(mont.exp_digits(e, window, nd)), window)

    def constmul_n(self):
        """Cached Toeplitz plan for x * n at width L -> 2L (limbmm).

        Built under ensure_compile_time_eval: the first call may come
        from inside a jit trace, and caching trace-local tracers leaks
        them into every later trace."""
        if "constmul_n" not in self.jit_cache:
            from ..bigint.limbmm import ConstMulPlan
            with jax.ensure_compile_time_eval():
                self.jit_cache["constmul_n"] = ConstMulPlan.build(
                    self.pk.n, self.L, 2 * self.L)
        return self.jit_cache["constmul_n"]

    def _widen(self, x: jax.Array, level: int) -> jax.Array:
        """Pad a mod-n^(s+1) result to the canonical ciphertext limb width."""
        import jax.numpy as jnp
        want = self.limbs_for_level(level)
        pad = want - x.shape[-1]
        if pad <= 0:
            return x[..., :want]
        return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])

    def hs_for_level(self, level: int) -> jax.Array:
        """Alternative-encryption randomness generator h_s (lazy, host pow):
        h1 = (n-h)^n mod n^2, h2 = (n^2-h)^(n^2) mod n^3
        (reference: paillier.go:416-434)."""
        if level not in self._hs:
            val = self.hs_int_for_level(level)
            width = self.limbs_for_level(level)
            with jax.ensure_compile_time_eval():   # may be hit in-trace
                self._hs[level] = jnp.asarray(host.int_to_limbs(val, width))
        return self._hs[level]

    def hs_int_for_level(self, level: int) -> int:
        """h_s as a Python int (host pow; reference: paillier.go:416-434)."""
        if not hasattr(self, "_hs_int"):
            self._hs_int = {}
        if level not in self._hs_int:
            pk = self.pk
            if level == LEVEL_ONE:
                self._hs_int[level] = pow(pk.n - pk.h, pk.n, pk.n2)
            else:
                self._hs_int[level] = pow(pk.n2 - pk.h, pk.n2, pk.n3)
        return self._hs_int[level]

    @classmethod
    def from_public(cls, pk: PublicKey) -> "DeviceKey":
        return cls(pk)

    @property
    def ctx_n3(self) -> MontCtx:
        if self._ctx_n3 is None:
            self._ctx_n3 = make_mont_ctx(self.pk.n3, 3 * self.L)
        return self._ctx_n3

    def ctx_for_level(self, level: int) -> MontCtx:
        return self.ctx_n2 if level == LEVEL_ONE else self.ctx_n3

    def limbs_for_level(self, level: int) -> int:
        return 2 * self.L if level == LEVEL_ONE else 3 * self.L


# ---------------------------------------------------------------------------
# host <-> device value helpers
# ---------------------------------------------------------------------------

def encode_batch(values, n_limbs: int) -> jax.Array:
    """List of Python ints -> uint32[B, n_limbs] device tensor."""
    return jnp.asarray(host.ints_to_limbs(list(values), n_limbs))


def decode_batch(arr) -> list[int]:
    """uint32[B, L] -> list of Python ints."""
    return host.limbs_to_ints(np.asarray(jax.device_get(arr)))
