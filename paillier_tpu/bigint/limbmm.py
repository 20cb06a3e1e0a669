"""Limb-domain big-int ops as int8 matmuls (the Toeplitz toolkit).

The scan-based limb kernels in :mod:`vpu` cost O(L) sequential steps per
multiply — tens of milliseconds at 4096-bit widths.  But every limb-domain
multiplication on the framework's hot paths has a *constant* operand (the
modulus n, a Hensel inverse, mu = lambda^-1, CRT constants...), so each one
is a linear map of the input's limbs and compiles to ONE ``i8 x i8 -> i32``
matmul against a host-precomputed Toeplitz-chunk matrix:

  x * d             -> ConstMulPlan   (optionally truncated: x*d mod 2^16L)
  (x * d) mod N     -> ModMulConstPlan (mod folded into the matrix entries;
                       output is a bounded representative, < 2^26 * N)
  x mod N (wide x)  -> FoldPlan       (entries (2^(16a+7c)) mod N)

plus :func:`barrett_small`, the exact O(L) reduction for values < 2^28 * N
(covers all bounded representatives above and the < lambda*N outputs of the
RNS engine).

Matrix layout (same convention as rns2.Rns2Converter): lhs rows are the
three 7/7/2-bit chunks of each input limb; matrix columns are the three
7/7/2-bit chunks of each output limb; the int32 column sums are recombined
with carry routing into the next limb and normalized once.

Replaces gmp.Mul/Mod on decryption's L-function and CRT recombination
(reference: paillier.go:296-340, 437-440 — the reference does these with
full gmp arithmetic; here they are int8 matmuls).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import host, vpu

CHUNK = 7
_MASK7 = (1 << CHUNK) - 1


def _chunk_rows(x: jnp.ndarray) -> jnp.ndarray:
    """uint32 limbs [..., L] -> int8 [..., 3L] (7,7,2-bit chunk blocks)."""
    xi = x.astype(jnp.int32)
    return jnp.concatenate([xi & _MASK7, (xi >> CHUNK) & _MASK7,
                            xi >> (2 * CHUNK)], axis=-1).astype(jnp.int8)


def _chunk_cols(W: np.ndarray) -> np.ndarray:
    """int64 limb matrix [R, L] -> int8 [R, 3L] column chunk blocks."""
    return np.concatenate([W & _MASK7, (W >> CHUNK) & _MASK7,
                           W >> (2 * CHUNK)], axis=1).astype(np.int8)


def _recombine3(P: jnp.ndarray) -> jnp.ndarray:
    """int32 [..., 3L] chunk column sums -> uint32 limbs [..., L].

    Routes the high bits of the shifted chunk blocks into the next limb
    (weight 2^16) to stay under vpu.normalize's < 2^31 bound.
    """
    L = P.shape[-1] // 3
    P0 = P[..., :L].astype(jnp.uint32)
    P1 = P[..., L:2 * L].astype(jnp.uint32)
    P2 = P[..., 2 * L:].astype(jnp.uint32)
    lo = P0 + ((P1 & 0x1FF) << CHUNK) + ((P2 & 0x3) << (2 * CHUNK))
    hi = (P1 >> 9) + (P2 >> 2)
    hi_shift = jnp.concatenate(
        [jnp.zeros_like(hi[..., :1]), hi[..., :-1]], axis=-1)
    return vpu.normalize(lo + hi_shift)


def _toeplitz_rows(d_int: int, lin: int, lout: int) -> np.ndarray:
    """[3*lin, lout] limb matrix: row (c, a) holds limbs of (d << 7c) << 16a,
    truncated to lout limbs (exact when lout covers the full product)."""
    rows = np.zeros((3 * lin, lout), dtype=np.int64)
    for c in range(3):
        dc = d_int << (CHUNK * c)
        ld = host.limbs_for_bits(dc.bit_length() or 1)
        dc_limbs = host.int_to_limbs(dc, ld).astype(np.int64)
        for a in range(lin):
            if a >= lout:
                break
            span = min(ld, lout - a)
            rows[c * lin + a, a:a + span] = dc_limbs[:span]
    return rows


class ConstMulPlan(NamedTuple):
    """x * d (exact, or low-truncated) as one int8 matmul."""

    mat: jax.Array     # int8 [3*lin, 3*lout]
    lin: int
    lout: int

    @classmethod
    def build(cls, d_int: int, lin: int, lout: int | None = None
              ) -> "ConstMulPlan":
        lout = lout or lin + host.limbs_for_bits(d_int.bit_length())
        return cls(mat=jnp.asarray(_chunk_cols(_toeplitz_rows(
            d_int, lin, lout))), lin=lin, lout=lout)


class ModMulConstPlan(NamedTuple):
    """(x * d) mod N as one int8 matmul + barrett_small.

    Matrix entries are the limbs of ((d << (7c + 16a)) mod N); the matmul
    output represents a value === x*d (mod N) bounded by 3*lin*2^7*N,
    i.e. quotient < 2^(7 + log2(3*lin)) <= 2^26 for lin <= 2^16.
    """

    mat: jax.Array     # int8 [3*lin, 3*lf]
    lin: int
    lf: int

    @classmethod
    def build(cls, d_int: int, n_int: int, lin: int) -> "ModMulConstPlan":
        b = n_int.bit_length()
        lf = host.limbs_for_bits(b + 26)
        rows = np.zeros((3 * lin, lf), dtype=np.int64)
        for c in range(3):
            for a in range(lin):
                v = (d_int << (CHUNK * c + 16 * a)) % n_int
                rows[c * lin + a] = host.int_to_limbs(v, lf).astype(np.int64)
        return cls(mat=jnp.asarray(_chunk_cols(rows)), lin=lin, lf=lf)


class FoldPlan(NamedTuple):
    """wide x -> bounded representative of x mod N (d = 1 special case)."""

    mat: jax.Array
    lin: int
    lf: int

    @classmethod
    def build(cls, n_int: int, lin: int) -> "FoldPlan":
        p = ModMulConstPlan.build(1, n_int, lin)
        return cls(mat=p.mat, lin=p.lin, lf=p.lf)


class BarrettPlan(NamedTuple):
    """Exact x mod N for x < 2^28 * N (small-quotient Barrett)."""

    n_limbs_arr: jax.Array   # uint32 [ln + 1]
    mu_limbs: jax.Array      # uint32 [4]: floor(2^(b+36) / N) (<= 2^37)
    b: int                   # N.bit_length()
    ln: int                  # limbs of N

    @classmethod
    def build(cls, n_int: int) -> "BarrettPlan":
        b = n_int.bit_length()
        ln = host.limbs_for_bits(b)
        mu = (1 << (b + 36)) >> 0
        mu = mu // n_int
        return cls(
            n_limbs_arr=jnp.asarray(host.int_to_limbs(n_int, ln + 1)),
            mu_limbs=jnp.asarray(host.int_to_limbs(mu, 4)),
            b=b, ln=ln)


def _shift_right_bits(x: jnp.ndarray, bits: int, keep: int) -> jnp.ndarray:
    """floor(x / 2^bits) keeping ``keep`` limbs (static shift amounts)."""
    k, r = divmod(bits, 16)
    L = x.shape[-1]
    if k >= L:
        return jnp.zeros(x.shape[:-1] + (keep,), jnp.uint32)
    x = x[..., k:]
    pad = keep + 1 - x.shape[-1]
    if pad > 0:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    x = x[..., :keep + 1]
    if r:
        lo = x[..., :keep] >> r
        hi = (x[..., 1:keep + 1] << (16 - r)) & 0xFFFF
        return lo + hi
    return x[..., :keep]


def const_mul(x: jnp.ndarray, plan: ConstMulPlan) -> jnp.ndarray:
    """uint32 limbs [..., lin] -> uint32 limbs [..., lout] of x*d
    (low-truncated to lout limbs — exact division callers rely on this)."""
    P = lax.dot_general(_chunk_rows(x), plan.mat,
                        (((x.ndim - 1,), (0,)), ((), ())),
                        preferred_element_type=jnp.int32)
    return _recombine3(P)


def modmul_const(x: jnp.ndarray, plan: ModMulConstPlan,
                 br: BarrettPlan) -> jnp.ndarray:
    """(x * d) mod N exactly: one matmul + small Barrett."""
    P = lax.dot_general(_chunk_rows(x), plan.mat,
                        (((x.ndim - 1,), (0,)), ((), ())),
                        preferred_element_type=jnp.int32)
    return barrett_small(_recombine3(P), br)


def fold_mod(x: jnp.ndarray, plan: FoldPlan, br: BarrettPlan) -> jnp.ndarray:
    """x mod N exactly for wide x (one matmul + small Barrett)."""
    return modmul_const(x, ModMulConstPlan(plan.mat, plan.lin, plan.lf), br)


def barrett_small(x: jnp.ndarray, br: BarrettPlan) -> jnp.ndarray:
    """Exact x mod N for 0 <= x < 2^28 * N; returns [..., ln].

    q_hat = floor(floor(x / 2^(b-8)) * mu / 2^(b+44-b-8... )): with
    mu = floor(2^(b+36)/N), q_hat = floor(x1 * mu / 2^44) where
    x1 = floor(x / 2^(b-8)) < 2^36.  Standard Barrett error analysis gives
    q - q_hat in {0, 1, 2}; three conditional subtracts finish exactly.
    """
    b, ln = br.b, br.ln
    x1 = _shift_right_bits(x, b - 8, 3)                 # < 2^36, 3 limbs
    prod = vpu.mul(x1, br.mu_limbs, 7)                  # x1 * mu < 2^73
    qhat = _shift_right_bits(prod, 44, 2)               # quotient < 2^28
    qn = vpu.mul(qhat, br.n_limbs_arr, ln + 1)
    xw = x[..., :ln + 1]
    pad = ln + 1 - xw.shape[-1]
    if pad > 0:
        xw = jnp.pad(xw, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    r, _ = vpu.sub(xw, qn)
    nb = jnp.broadcast_to(br.n_limbs_arr, r.shape)
    r = vpu.cond_sub(r, nb)
    r = vpu.cond_sub(r, nb)
    r = vpu.cond_sub(r, nb)
    return r[..., :ln]
