"""Batched decryption (reference: paillier.go:292-372).

Generic path:  m = recovery(c^lambda mod n^(s+1), s) * lambda^{-1} mod n^s
with the Damgard-Jurik recovery algorithm (paillier.go:308-340) — the
L(u,n) = (u-1)/n exact divisions run on device via Hensel inverses.

CRT fast path (level 1, not present in the reference — BASELINE config #2):
decrypt mod p^2 and q^2 at half width with half-length exponents, then CRT
recombine.  ~4x less work than the generic path.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..bigint import host, vpu
from ..bigint import montgomery as mont
from .keys import (DEFAULT_LEVEL, LEVEL_ONE, LEVEL_TWO, Ciphertext,
                   DeviceKey, SecretKey, decode_batch, encode_batch)


# ---------------------------------------------------------------------------
# Generic recovery-algorithm decryption
# ---------------------------------------------------------------------------

def _L_div(u_minus_1: jnp.ndarray, hensel: jnp.ndarray, out_len: int
           ) -> jnp.ndarray:
    """L(u, n) = (u-1)/n via exact Hensel division (paillier.go:437-440)."""
    return mont.exact_div(u_minus_1, hensel, out_len)


def decrypt_kernel(dk: DeviceKey, c: jnp.ndarray, level: int,
                   lam_digits: jnp.ndarray, mu_limbs: jnp.ndarray,
                   inv2fac_n2: jnp.ndarray, window: int = 4) -> jnp.ndarray:
    """Generic decryption; returns m [..., sL].

    lam_digits: shared exponent digits of lambda; mu_limbs: lambda^{-1}
    mod n^s; inv2fac_n2: n * (2!)^{-1} mod n^2 (only used at level 2).
    """
    ctx = dk.ctx_for_level(level)
    tmp = mont.mont_pow_digits(ctx, c, lam_digits, window)  # c^lambda
    return _recover(dk, tmp, level, mu_limbs, inv2fac_n2)


def decrypt_kernel_rns(dk: DeviceKey, eng, c: jnp.ndarray, level: int,
                       lam_exp: int, mu_limbs: jnp.ndarray,
                       inv2fac_n2: jnp.ndarray, window: int = 4
                       ) -> jnp.ndarray:
    """Generic decryption with c^lambda on the RNS engine
    (sliding-window shared-exponent ladder)."""
    t_rns = eng.pow_shared(eng.from_limbs(c), lam_exp)
    tmp = dk._widen(eng.to_limbs_mod(t_rns), level)
    return _recover(dk, tmp, level, mu_limbs, inv2fac_n2)


def _recover(dk: DeviceKey, tmp: jnp.ndarray, level: int,
             mu_limbs: jnp.ndarray, inv2fac_n2: jnp.ndarray) -> jnp.ndarray:
    """Shared Damgard-Jurik recovery from tmp = c^lambda mod n^(s+1)."""
    L = dk.L
    one = jnp.zeros_like(tmp).at[..., 0].set(1)
    um1, _ = vpu.sub(tmp, one)

    if level == LEVEL_ONE:
        ml = _L_div(um1, dk.n_hensel_L, L)                  # (u-1)/n < n
        return mont.modmul(dk.ctx_n, ml,
                           jnp.broadcast_to(mu_limbs, ml.shape))

    # level 2 recovery (paillier.go:308-340), specialized to s=2:
    #   i1 = L(a mod n^2, n)
    #   t1 = L(a mod n^3, n);  t2 = i1*(i1-1)*n*(2!)^{-1} mod n^2
    #   ml = (t1 - t2) mod n^2
    # a mod n^2 is a unit (a = c^lambda with c invertible), so subtracting 1
    # cannot underflow.
    a_mod_n2 = mont.mod_wide(dk.ctx_n2, tmp)
    one2 = jnp.zeros_like(a_mod_n2).at[..., 0].set(1)
    um1_2, _ = vpu.sub(a_mod_n2, one2)
    i1 = _L_div(um1_2, dk.n_hensel_2L, 2 * L)[..., :L]       # < n
    t1 = _L_div(um1, dk.n_hensel_2L, 2 * L)                  # < n^2

    # t2 = i1 * (i1 - 1) (both < n, so the product < n^2 is already reduced)
    one1 = jnp.zeros((1,) * (i1.ndim - 1) + (L,), jnp.uint32).at[..., 0].set(1)
    i1m1, borrow = vpu.sub(i1, jnp.broadcast_to(one1, i1.shape))
    # if i1 == 0 the product is 0 anyway; keep wrap-around value masked to 0
    prod = vpu.mul(i1, i1m1, 2 * L)
    prod = jnp.where(vpu.is_zero(i1)[..., None], jnp.zeros_like(prod), prod)
    # t2 *= n * (2!)^{-1} mod n^2 (single fused host constant)
    t2 = mont.modmul(dk.ctx_n2, prod,
                     jnp.broadcast_to(inv2fac_n2, prod.shape))
    # ml = (t1 - t2) mod n^2
    diff, borrow = vpu.sub(t1, t2)
    n2b = jnp.broadcast_to(dk.ctx_n2.n, diff.shape)
    fixed, _ = vpu.add(diff, n2b)
    ml = jnp.where(borrow[..., None] != 0, fixed, diff)
    return mont.modmul(dk.ctx_n2, ml, jnp.broadcast_to(mu_limbs, ml.shape))


# ---------------------------------------------------------------------------
# CRT decryption (level 1)
# ---------------------------------------------------------------------------

class _CrtConsts:
    def __init__(self, sk: SecretKey):
        p, q, n = sk.p, sk.q, sk.n
        self.p2, self.q2 = p * p, q * q
        # h_p = L_p(g^{p-1} mod p^2)^{-1} mod p  (g = n+1)
        hp = pow(sk.g, p - 1, self.p2)
        hq = pow(sk.g, q - 1, self.q2)
        self.hp_int = pow((hp - 1) // p, -1, p)
        self.hq_int = pow((hq - 1) // q, -1, q)
        self.pinv_q = pow(p, -1, q)


class _CrtMmPlans:
    """limbmm plans for the int8-matmul CRT decryption path (one per secret key).

    Every limb-domain multiply in CRT decryption has a constant operand,
    so each becomes one int8 Toeplitz matmul (+ small Barrett where a
    modular result is needed) instead of an O(L)-step vpu scan.
    """

    def __init__(self, sk: SecretKey, cc: _CrtConsts, c_limbs: int):
        from ..bigint import limbmm as lm
        p, q = sk.p, sk.q
        Lh = host.limbs_for_bits(max(cc.p2.bit_length(), cc.q2.bit_length()))
        Lp = host.limbs_for_bits(max(p.bit_length(), q.bit_length()))
        self.Lh, self.Lp = Lh, Lp
        # c mod p^2 / q^2: fold the 2L-wide ciphertext
        self.fold_p2 = lm.FoldPlan.build(cc.p2, c_limbs)
        self.fold_q2 = lm.FoldPlan.build(cc.q2, c_limbs)
        self.br_p2 = lm.BarrettPlan.build(cc.p2)
        self.br_q2 = lm.BarrettPlan.build(cc.q2)
        # exact division by p / q (Hensel inverse, low-truncated product)
        self.div_p = lm.ConstMulPlan.build(
            host.hensel_inverse(p, Lh), Lh, Lh)
        self.div_q = lm.ConstMulPlan.build(
            host.hensel_inverse(q, Lh), Lh, Lh)
        # * h_p mod p, * h_q mod q (inputs are the Lp-limb L-function values)
        self.hp = lm.ModMulConstPlan.build(cc.hp_int, p, Lp)
        self.hq = lm.ModMulConstPlan.build(cc.hq_int, q, Lp)
        self.br_p = lm.BarrettPlan.build(p)
        self.br_q = lm.BarrettPlan.build(q)
        # CRT combine: * p^-1 mod q, then * p (exact widen)
        self.pinv_q = lm.ModMulConstPlan.build(cc.pinv_q, q, Lp)
        self.mul_p = lm.ConstMulPlan.build(p, Lp, c_limbs // 2)
        self.q_limbs = jnp.asarray(host.int_to_limbs(q, Lp))


def crt_decrypt_kernel_mm(dk: DeviceKey, c: jnp.ndarray, pl: "_CrtMmPlans",
                          eng_p, eng_q, ep_exp: int, eq_exp: int,
                          window: int = 4) -> jnp.ndarray:
    """int8-matmul CRT decryption: every limb multiply is a Toeplitz matmul and
    both half-width modexps run on the fused RNS sliding-window kernel
    (shared exponents p-1 / q-1)."""
    from ..bigint import limbmm as lm
    L = dk.L
    Lh, Lp = pl.Lh, pl.Lp

    def half(fold, br2, eng, e_exp, div, hplan, br1):
        cm = lm.fold_mod(c, fold, br2)                       # c mod p^2
        u = eng.pow_shared(eng.from_limbs(cm), e_exp)        # c^(p-1)
        ul = eng.to_limbs_mod(u)[..., :Lh]
        one = jnp.zeros_like(ul).at[..., 0].set(1)
        um1, _ = vpu.sub(ul, one)
        lval = lm.const_mul(um1, div)[..., :Lp]              # L_p(u) < p
        return lm.modmul_const(lval, hplan, br1)             # * h_p mod p

    mp = half(pl.fold_p2, pl.br_p2, eng_p, ep_exp, pl.div_p, pl.hp,
              pl.br_p)
    mq = half(pl.fold_q2, pl.br_q2, eng_q, eq_exp, pl.div_q, pl.hq,
              pl.br_q)

    # m = mp + p * ((mq - mp) * p^-1 mod q)
    qb = jnp.broadcast_to(pl.q_limbs, mp.shape)
    mp_q = vpu.cond_sub(mp, qb)
    diff, borrow = vpu.sub(mq, mp_q)
    fixed, _ = vpu.add(diff, qb)
    diff = jnp.where(borrow[..., None] != 0, fixed, diff)
    t = lm.modmul_const(diff, pl.pinv_q, pl.br_q)
    pt = lm.const_mul(t, pl.mul_p)                            # t * p, exact
    m, _ = vpu.add(pt, jnp.pad(mp, [(0, 0)] * (mp.ndim - 1)
                               + [(0, L - mp.shape[-1])]))
    return m


def crt_decrypt_kernel(dk: DeviceKey, c: jnp.ndarray,
                       ctx_p2, ctx_q2, ctx_p, ctx_q,
                       ep_digits, eq_digits,
                       p_hensel, q_hensel, hp, hq, pinv_q, p_limbs,
                       window: int = 4, rns_halves=None) -> jnp.ndarray:
    """m = CRT(m_p, m_q) with m_p = L_p(c^{p-1} mod p^2) h_p mod p.

    ``rns_halves``: optional ((eng_p, conv_p), (eng_q, conv_q)) — when
    given, the two half-width modexps run on RNS engines.
    """
    L = dk.L
    Lh = ctx_p2.n_limbs    # = L (p^2 has ~n bits)
    Lp = ctx_p.n_limbs

    def half(ctx2, ctx1, e_digits, hensel, hfac, rns_half):
        cm = mont.mod_wide(ctx2, c[..., :2 * Lh])
        if rns_half is not None:
            eng = rns_half
            u_rns = eng.pow(eng.from_limbs(cm), e_digits, window)
            u = mont.mod_wide_any(ctx2, eng.to_limbs(u_rns))
        else:
            u = mont.mont_pow_digits(ctx2, cm, e_digits, window)
        one = jnp.zeros_like(u).at[..., 0].set(1)
        um1, _ = vpu.sub(u, one)
        lval = _L_div(um1, hensel, Lh)[..., :Lp]
        return mont.modmul(ctx1, lval, jnp.broadcast_to(hfac, lval.shape))

    rh = rns_halves or (None, None)
    mp = half(ctx_p2, ctx_p, ep_digits, p_hensel, hp, rh[0])
    mq = half(ctx_q2, ctx_q, eq_digits, q_hensel, hq, rh[1])

    # m = mp + p * ((mq - mp) * p^{-1} mod q)
    Lq = ctx_q.n_limbs
    mp_q = vpu.cond_sub(mp[..., :Lq], jnp.broadcast_to(ctx_q.n, mp[..., :Lq].shape))
    diff, borrow = vpu.sub(mq, mp_q)
    qb = jnp.broadcast_to(ctx_q.n, diff.shape)
    fixed, _ = vpu.add(diff, qb)
    diff = jnp.where(borrow[..., None] != 0, fixed, diff)
    t = mont.modmul(ctx_q, diff, jnp.broadcast_to(pinv_q, diff.shape))
    pt = vpu.mul(t, p_limbs, L)
    m, _ = vpu.add(pt, jnp.pad(mp, [(0, 0)] * (mp.ndim - 1)
                               + [(0, L - mp.shape[-1])]))
    return m


# ---------------------------------------------------------------------------
# User-facing decryptor
# ---------------------------------------------------------------------------

class Decryptor:
    """Batched, jitted decryption for one secret key."""

    def __init__(self, sk: SecretKey, level: int = DEFAULT_LEVEL,
                 crt: bool = False, window: int | None = None,
                 engine: str = "auto"):
        from ..config import get_config
        self.sk = sk
        self.dk = sk.device()
        self.level = level
        window = window if window is not None else get_config().window
        self.window = window
        self.crt = crt and level == LEVEL_ONE
        s = 1 if level == LEVEL_ONE else 2
        self.s = s
        L = self.dk.L
        if engine == "auto":
            # same dispatch rule as every other component, incl. the
            # PAILLIER_TPU_FORCE_RNS test override (keys.py use_rns)
            engine = "rns" if self.dk.use_rns() else "limb"
        self.engine = engine

        cache_key = ("dec", self.crt, level, window, engine)
        if cache_key in self.dk.jit_cache:
            self._fn = self.dk.jit_cache[cache_key]
        elif self.crt:
            cc = _CrtConsts(sk)
            p, q = sk.p, sk.q
            nd = mont.n_digits_for_bits(max(p.bit_length(), q.bit_length()),
                                        window)
            ep = jnp.asarray(mont.exp_digits(p - 1, window, nd))
            eq = jnp.asarray(mont.exp_digits(q - 1, window, nd))
            if self.dk.use_rns() and engine != "limb":
                # limbmm Toeplitz matmuls + RNS modexps
                from ..bigint.engine import make_engine
                plans = _CrtMmPlans(sk, cc, 2 * L)
                eng_p = make_engine(cc.p2, plans.Lh)
                eng_q = make_engine(cc.q2, plans.Lh)
                self._fn = jax.jit(lambda c: crt_decrypt_kernel_mm(
                    self.dk, c, plans, eng_p, eng_q, p - 1, q - 1, window))
                self.dk.jit_cache[cache_key] = self._fn
            else:
                Lh = L  # p^2, q^2 at full-L width: c (2L limbs) reduces exactly
                Lp = host.limbs_for_bits(max(p.bit_length(), q.bit_length()))
                ctx_p2 = mont.make_mont_ctx(cc.p2, Lh)
                ctx_q2 = mont.make_mont_ctx(cc.q2, Lh)
                ctx_p = mont.make_mont_ctx(p, Lp)
                ctx_q = mont.make_mont_ctx(q, Lp)
                ph = jnp.asarray(host.int_to_limbs(
                    host.hensel_inverse(p, Lh), Lh))
                qh = jnp.asarray(host.int_to_limbs(
                    host.hensel_inverse(q, Lh), Lh))
                hp = jnp.asarray(host.int_to_limbs(cc.hp_int, Lp))
                hq = jnp.asarray(host.int_to_limbs(cc.hq_int, Lp))
                piq = jnp.asarray(host.int_to_limbs(cc.pinv_q, Lp))
                pl = jnp.asarray(host.int_to_limbs(p, Lp))
                self._fn = jax.jit(lambda c: crt_decrypt_kernel(
                    self.dk, c, ctx_p2, ctx_q2, ctx_p, ctx_q, ep, eq,
                    ph, qh, hp, hq, piq, pl, window, None))
                self.dk.jit_cache[cache_key] = self._fn
        else:
            ns = sk.n ** s
            nd = mont.n_digits_for_bits(sk.lam.bit_length(), window)
            lam_digits = jnp.asarray(mont.exp_digits(sk.lam, window, nd))
            mu = jnp.asarray(host.int_to_limbs(
                pow(sk.lam, -1, ns), s * L))
            inv2fac = jnp.asarray(host.int_to_limbs(
                (sk.n * pow(2, -1, sk.n2)) % sk.n2, 2 * L))
            if engine == "rns":
                eng = self.dk.rns(level)
                lam = sk.lam
                self._fn = jax.jit(lambda c: decrypt_kernel_rns(
                    self.dk, eng, c, level, lam, mu, inv2fac, window))
            else:
                self._fn = jax.jit(lambda c: decrypt_kernel(
                    self.dk, c, level, lam_digits, mu, inv2fac, window))
            self.dk.jit_cache[cache_key] = self._fn

    def decrypt(self, ct: Ciphertext) -> list[int]:
        if ct.level != self.level:
            raise ValueError(
                f"decryptor built for level {self.level}, got {ct.level}")
        return decode_batch(self._fn(ct.c))

    def decrypt_array(self, ct: Ciphertext) -> jax.Array:
        return self._fn(ct.c)


def nested_decrypt(sk: SecretKey, ct: Ciphertext, window: int = 4
                   ) -> list[int]:
    """Peel two layers (reference: paillier.go:344-355), honoring the
    inner-zero edge case."""
    inner = decrypt_nested_layer(sk, ct, window)
    inner_vals = decode_batch(inner.c)
    d1 = Decryptor(sk, LEVEL_ONE, window=window)
    outer = d1.decrypt(Ciphertext(c=inner.c, level=LEVEL_ONE))
    return [0 if iv == 0 else ov for iv, ov in zip(inner_vals, outer)]


def decrypt_nested_layer(sk: SecretKey, ct: Ciphertext, window: int = 4
                         ) -> Ciphertext:
    """[[c]] -> [c] (reference: paillier.go:359-372)."""
    if ct.level == LEVEL_ONE:
        raise ValueError("no nested ciphertexts to recover")
    d2 = Decryptor(sk, LEVEL_TWO, window=window)
    vals = d2.decrypt_array(ct)
    return Ciphertext(c=vals, level=LEVEL_ONE, method="mixed")
