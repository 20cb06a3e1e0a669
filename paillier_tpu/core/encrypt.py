"""Batched encryption (reference: paillier.go:185-289).

Regular encryption:      c = G^m * r^(n^s)    mod n^(s+1)   (G = n+1)
Alternative encryption:  c = G^m * h_s^r      mod n^(s+1),  r < K
Nested encryption:       Enc_2(Enc_1(m).c)

Design choices:
* G^m uses the binomial identity (1+n)^m = 1 + m n (+ C(m,2) n^2) mod
  n^(s+1) — two limb multiplies instead of a full modexp.  The reference
  does the full modexp (paillier.go:213); outputs are bit-identical.
* r^(n^s) is a fixed-window Montgomery ladder with the *shared* exponent
  n^s (one compiled scan, batch in lanes).
* h_s^r uses a batch-shared power table of the fixed base h_s with
  per-element short exponents r < K = 2^(secparam/2)
  (reference: paillier.go:221-238).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..bigint import host, vpu
from ..bigint import montgomery as mont
from ..ops import random as prand
from .keys import (ALTERNATIVE, DEFAULT_LEVEL, LEVEL_ONE, LEVEL_TWO, MIXED,
                   REGULAR, Ciphertext, DeviceKey, PublicKey, encode_batch)


# ---------------------------------------------------------------------------
# G^m via the binomial shortcut (device)
# ---------------------------------------------------------------------------

def gm_binomial(dk: DeviceKey, m: jnp.ndarray, level: int) -> jnp.ndarray:
    """(1+n)^m mod n^(s+1) for plaintext m < n^s.

    Level 1: 1 + m*n (exact, < n^2 — no reduction needed).
    Level 2: 1 + m*n + C(m,2)*n^2 mod n^3, with C(m,2) taken mod n.
    """
    L = dk.L
    if level == LEVEL_ONE:
        # m: [..., L] < n ; c = 1 + m*n at width 2L.  On accelerators the
        # constant-operand multiply is an int8 Toeplitz matmul
        # (limbmm) instead of the O(L)-step vpu scan.
        if dk.use_rns():
            from ..bigint.limbmm import const_mul
            t = const_mul(m, dk.constmul_n())
        else:
            t = vpu.mul(m, dk.ctx_n.n, 2 * L)
        c, _ = vpu.add(t, jnp.zeros_like(t).at[..., 0].set(1))
        return c
    # level 2: m: [..., 2L] < n^2
    t1 = vpu.mul(m, dk.ctx_n.n, 3 * L)                       # m*n < n^3
    mr = mont.mod_wide(dk.ctx_n, m)                          # m mod n [..., L]
    one = jnp.zeros_like(mr).at[..., 0].set(1)
    mr_minus, borrow = vpu.sub(mr, one)                      # (m-1) mod n
    mr_minus = jnp.where(borrow[..., None] != 0,
                         vpu.sub(dk.ctx_n.n + jnp.zeros_like(mr), one)[0],
                         mr_minus)
    inv2 = jnp.broadcast_to(dk.inv2_n, mr.shape)
    b2 = mont.modmul(dk.ctx_n, mont.modmul(dk.ctx_n, mr, mr_minus), inv2)
    t2 = vpu.mul(b2, dk.ctx_n2.n, 3 * L)                     # C(m,2)*n^2 < n^3
    s12, c12 = vpu.add(t1, t2)
    s12 = jnp.concatenate([s12, c12[..., None]], axis=-1)    # width 3L+1
    one3 = jnp.zeros_like(s12).at[..., 0].set(1)
    c, _ = vpu.add(s12, one3)
    n3_pad = jnp.pad(jnp.broadcast_to(dk.ctx_n3.n, c.shape[:-1] + (3 * L,)),
                     [(0, 0)] * (c.ndim - 1) + [(0, 1)])
    return vpu.cond_sub(c, n3_pad)[..., :3 * L]


# ---------------------------------------------------------------------------
# Functional kernels
# ---------------------------------------------------------------------------

def encrypt_with_r_kernel(dk: DeviceKey, m: jnp.ndarray, r: jnp.ndarray,
                          level: int, ns_digits: jnp.ndarray,
                          window: int = 4) -> jnp.ndarray:
    """c = G^m * r^(n^s) mod n^(s+1); m [..., sL], r [..., (s+1)L] padded."""
    ctx = dk.ctx_for_level(level)
    gm = gm_binomial(dk, m, level)
    rn = mont.mont_pow_digits(ctx, r, ns_digits, window)
    return mont.modmul(ctx, gm, rn)


def encrypt_with_r_rns_kernel(dk: DeviceKey, eng, m: jnp.ndarray,
                              r: jnp.ndarray, level: int, ns_exp: int,
                              window: int = 4) -> jnp.ndarray:
    """RNS fast path: r^(n^s) runs in the Cox-Rower engine (int8 base
    extensions) via the sliding-window shared-exponent ladder; G^m via
    the limb binomial shortcut; outputs are bit-identical to the limb
    path."""
    gm = gm_binomial(dk, m, level)
    rn = eng.pow_shared(eng.from_limbs(r), ns_exp)
    c_rns = eng.mul(eng.from_limbs(gm), rn)
    return dk._widen(eng.to_limbs_mod(c_rns), level)


def encrypt_with_r_rns_fused_kernel(dk: DeviceKey, eng, nrow: jnp.ndarray,
                                    m: jnp.ndarray, r: jnp.ndarray,
                                    ns_exp: int) -> jnp.ndarray:
    """Level-1 RNS fast path with G^m fused into the ladder.

    G^m = 1 + m*n is computed directly in residue space (one
    multiply-add + reduction per channel; rns2.rns2_one_plus_mul) and
    multiplied into r^n by the ladder's mandatory exit multiply — the
    separate eng.mul dispatch, the limb-domain Toeplitz const-mul and
    the extra limb->residue conversion of the old path all disappear.
    Bit-identical to encrypt_with_r_rns_kernel (and to the reference:
    paillier.go:206-218)."""
    from ..bigint.rns2 import rns2_one_plus_mul
    L = dk.L
    m_wide = jnp.pad(m, [(0, 0)] * (m.ndim - 1) + [(0, L)])  # width 2L
    gm = rns2_one_plus_mul(eng.ctx, eng.from_limbs(m_wide), nrow)
    c_rns = eng.pow_shared(eng.from_limbs(r), ns_exp, fin=gm)
    return dk._widen(eng.to_limbs_mod(c_rns), LEVEL_ONE)


def alt_encrypt_with_r_kernel(dk: DeviceKey, m: jnp.ndarray,
                              r_digits: jnp.ndarray, level: int,
                              window: int = 4) -> jnp.ndarray:
    """c = G^m * h_s^r mod n^(s+1) with per-element short exponents r < K."""
    ctx = dk.ctx_for_level(level)
    gm = gm_binomial(dk, m, level)
    hs = dk.hs_for_level(level)
    hr = mont.mont_pow_fixed_base(ctx, hs, r_digits, window)
    return mont.modmul(ctx, gm, hr)


def alt_encrypt_comb_kernel(dk: DeviceKey, eng, table, m: jnp.ndarray,
                            r_digits: jnp.ndarray, level: int,
                            window: int = 4) -> jnp.ndarray:
    """Comb fast path: h_s^r with ZERO squarings (fixed-base table of
    Montgomery-form residues, one mmul per exponent digit) — the short
    randomness r < K = 2^(secparam/2) makes alternative encryption
    ~10x cheaper than the r^(n^s) ladder at production key sizes."""
    from ..bigint.rns2 import rns2_pow_fixed_base
    gm = gm_binomial(dk, m, level)
    hr = rns2_pow_fixed_base(eng.ctx, table, r_digits, window)
    c_rns = eng.mul(eng.from_limbs(gm), hr)
    return dk._widen(eng.to_limbs_mod(c_rns), level)


# ---------------------------------------------------------------------------
# User-facing encryptor
# ---------------------------------------------------------------------------

class Encryptor:
    """Batched, jitted encryption for one public key.

    ``method`` is "regular" (r^(n^s), reference paillier.go:206-218) or
    "alternative" (h_s^r with short randomness, paillier.go:221-238).
    """

    def __init__(self, pk: PublicKey, level: int = DEFAULT_LEVEL,
                 method: str = REGULAR, window: int | None = None, rng=None,
                 engine: str = "auto"):
        from ..config import get_config
        self.pk = pk
        self.dk = pk.device()
        self.level = level
        self.method = method
        window = window if window is not None else get_config().window
        self.window = window
        self.rng = rng or prand.make_rng()
        s = 1 if level == LEVEL_ONE else 2
        self.s = s
        self.m_limbs = s * self.dk.L
        self.c_limbs = (s + 1) * self.dk.L
        if engine == "auto":
            # RNS pays off for production key sizes on accelerators
            engine = "rns" if self.dk.use_rns() else "limb"
        self.engine = engine
        cache_key = ("enc", method, level, window, engine)
        if method == REGULAR:
            if cache_key not in self.dk.jit_cache:
                ns = pk.n ** s
                if engine == "rns":
                    from ..bigint.rns2 import Rns2Engine
                    eng = self.dk.rns(level)
                    if level == LEVEL_ONE and isinstance(eng, Rns2Engine):
                        # G^m fused into the ladder's exit multiply
                        spec = eng.spec
                        with jax.ensure_compile_time_eval():
                            nrow = jnp.asarray(np.asarray(
                                [pk.n % mi for mi in spec.b1 + spec.b2],
                                dtype=np.int32))
                        self.dk.jit_cache[cache_key] = jax.jit(
                            lambda m, r: encrypt_with_r_rns_fused_kernel(
                                self.dk, eng, nrow, m, r, ns))
                    else:
                        self.dk.jit_cache[cache_key] = jax.jit(
                            lambda m, r: encrypt_with_r_rns_kernel(
                                self.dk, eng, m, r, level, ns, window))
                else:
                    nd = mont.n_digits_for_bits(ns.bit_length(), window)
                    ns_digits = jnp.asarray(mont.exp_digits(ns, window, nd))
                    self.dk.jit_cache[cache_key] = jax.jit(
                        lambda m, r: encrypt_with_r_kernel(
                            self.dk, m, r, level, ns_digits, window))
            self._fn = self.dk.jit_cache[cache_key]
        elif method == ALTERNATIVE:
            self._r_bits = pk.k.bit_length() - 1  # r < K = 2^(secparam/2)
            if cache_key not in self.dk.jit_cache:
                from ..bigint.rns2 import Rns2Engine, build_fixed_base_table
                eng = self.dk.rns(level) if engine == "rns" else None
                if isinstance(eng, Rns2Engine):
                    hs_int = self.dk.hs_int_for_level(level)
                    nd = mont.n_digits_for_bits(self._r_bits, window)
                    table = build_fixed_base_table(eng, hs_int, nd, window)
                    self.dk.jit_cache[cache_key] = jax.jit(
                        lambda m, rd: alt_encrypt_comb_kernel(
                            self.dk, eng, table, m, rd, level, window))
                else:
                    self.dk.hs_for_level(level)  # materialize before tracing
                    self.dk.jit_cache[cache_key] = jax.jit(
                        lambda m, rd: alt_encrypt_with_r_kernel(
                            self.dk, m, rd, level, window))
            self._fn = self.dk.jit_cache[cache_key]
        else:
            raise ValueError(f"unknown encryption method {method!r}")

    # -- randomness -------------------------------------------------------
    def sample_r(self, count: int) -> list[int]:
        return prand.random_units(self.pk.n, count, self.rng)

    # -- encryption -------------------------------------------------------
    def encrypt(self, ms: Sequence[int] | jnp.ndarray,
                rs: Optional[Sequence[int]] = None) -> Ciphertext:
        """Encrypt a batch of plaintexts (ints < n^s, or a limb tensor)."""
        if isinstance(ms, (list, tuple)):
            m = encode_batch(ms, self.m_limbs)
            count = len(ms)
        else:
            m = jnp.asarray(ms)
            count = int(np.prod(m.shape[:-1])) if m.ndim > 1 else 1
        if rs is None:
            rs = self.sample_r(count)
        if self.method == REGULAR:
            r = encode_batch(rs, self.c_limbs).reshape(m.shape[:-1]
                                                       + (self.c_limbs,))
            c = self._fn(m, r)
        else:
            nd = mont.n_digits_for_bits(self._r_bits, self.window)
            rd = np.stack([mont.exp_digits(ri % self.pk.k, self.window, nd)
                           for ri in rs]).reshape(m.shape[:-1] + (nd,))
            c = self._fn(m, jnp.asarray(rd))
        return Ciphertext(c=c, level=self.level,
                          method=REGULAR if self.method == REGULAR
                          else ALTERNATIVE)

    def encrypt_zeros(self, count: int) -> Ciphertext:
        return self.encrypt([0] * count)

    def encrypt_ones(self, count: int) -> Ciphertext:
        return self.encrypt([1] * count)


def nested_encrypt(pk: PublicKey, ms: Sequence[int], rng=None,
                   window: int = 4) -> Ciphertext:
    """Enc_2(Enc_1(m).c) (reference: paillier.go:200-203).

    The inner level-1 ciphertext limbs ([..., 2L], values < n^2) are
    exactly the level-2 plaintext width, so they feed the level-2 kernel
    directly — no host decode/re-encode round-trip."""
    e1 = Encryptor(pk, LEVEL_ONE, REGULAR, window, rng)
    e2 = Encryptor(pk, LEVEL_TWO, REGULAR, window, rng)
    inner = e1.encrypt(list(ms))
    return e2.encrypt(inner.c)
