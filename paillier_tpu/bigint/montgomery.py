"""Batched Montgomery modular multiplication / exponentiation (pure jnp).

Replaces the reference's ``gmp.Int.Exp`` hot path (reference:
paillier.go:213-216, 296; thresholdkey.go:195-199; ddleq.go:81-87) with a
batched design: residues live as radix-2^16 limb vectors on device,
reduction is Montgomery (all Paillier moduli N^s are odd), and
exponentiation is a fixed-window ladder expressed as ``lax.scan`` over the
exponent digits so the whole modexp compiles to a single fused loop.

Throughput comes from the batch axis: every mont_mul is a vectorized
(batch, limbs) computation; the sequential depth is the exponent length.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import vpu
from .host import LIMB_BITS, int_to_limbs, limbs_for_bits, mont_nprime


class MontCtx(NamedTuple):
    """Montgomery context for a fixed odd modulus n (shared across a batch).

    All fields are uint32 limb vectors of length L = limbs(n); the struct is
    a pytree so it can be passed through jit/shard_map.
    """

    n: jax.Array        # the modulus
    nprime: jax.Array   # -n^{-1} mod R,  R = 2^(16 L)
    r2: jax.Array       # R^2 mod n   (to-Montgomery factor)
    one_m: jax.Array    # R mod n     (1 in Montgomery form)
    b2l: jax.Array      # R^2's cousin: 2^(32 L) mod n (wide folding)

    @property
    def n_limbs(self) -> int:
        return self.n.shape[-1]


def make_mont_ctx(n_int: int, n_limbs: int | None = None) -> MontCtx:
    """Host-side constructor from a Python-int odd modulus."""
    if n_int % 2 == 0:
        raise ValueError("Montgomery reduction requires an odd modulus")
    L = n_limbs or limbs_for_bits(n_int.bit_length())
    R = 1 << (LIMB_BITS * L)
    return MontCtx(
        n=jnp.asarray(int_to_limbs(n_int, L)),
        nprime=jnp.asarray(int_to_limbs(mont_nprime(n_int, L), L)),
        r2=jnp.asarray(int_to_limbs((R * R) % n_int, L)),
        one_m=jnp.asarray(int_to_limbs(R % n_int, L)),
        b2l=jnp.asarray(int_to_limbs((R * R) % n_int, L)),
    )


# ---------------------------------------------------------------------------
# Core Montgomery ops
# ---------------------------------------------------------------------------

@jax.jit
def mont_mul(ctx: MontCtx, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Montgomery product a*b*R^{-1} mod n for residues a, b < n.

    SOS form: full product, quotient digits via the precomputed
    -n^{-1} mod R, one conditional subtract at the end.
    """
    L = ctx.n_limbs
    t = vpu.mul(a, b)                          # [..., 2L], < n^2
    m = vpu.mul_low(t[..., :L], ctx.nprime, L)  # quotient digits, < R
    mn = vpu.mul(m, ctx.n)                     # [..., 2L]
    s, carry = vpu.add(t, mn)                  # t + m n == 0 mod R
    hi = jnp.concatenate([s[..., L:], carry[..., None]], axis=-1)  # (t+mn)/R
    n_pad = jnp.pad(jnp.broadcast_to(ctx.n, hi.shape[:-1] + (L,)),
                    [(0, 0)] * (hi.ndim - 1) + [(0, 1)])
    return vpu.cond_sub(hi, n_pad)[..., :L]


@jax.jit
def to_mont(ctx: MontCtx, x: jnp.ndarray) -> jnp.ndarray:
    """x -> x*R mod n (x must be < n, normalized limbs)."""
    return mont_mul(ctx, x, jnp.broadcast_to(ctx.r2, x.shape))


@jax.jit
def from_mont(ctx: MontCtx, x: jnp.ndarray) -> jnp.ndarray:
    """x*R^{-1} mod n (leave Montgomery domain)."""
    one = jnp.zeros_like(x).at[..., 0].set(1)
    return mont_mul(ctx, x, one)


@jax.jit
def modmul(ctx: MontCtx, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Plain modular product a*b mod n (one extra mont_mul to fix R)."""
    return mont_mul(ctx, mont_mul(ctx, a, b), jnp.broadcast_to(ctx.r2, a.shape))


@jax.jit
def mont_reduce_wide(ctx: MontCtx, t: jnp.ndarray) -> jnp.ndarray:
    """Montgomery-reduce a 2L-limb value t < R*n to t*R^{-1} mod n."""
    L = ctx.n_limbs
    m = vpu.mul_low(t[..., :L], ctx.nprime, L)
    mn = vpu.mul(m, ctx.n, 2 * L)
    s, carry = vpu.add(t, mn)
    hi = jnp.concatenate([s[..., L:], carry[..., None]], axis=-1)
    n_pad = jnp.pad(jnp.broadcast_to(ctx.n, hi.shape[:-1] + (L,)),
                    [(0, 0)] * (hi.ndim - 1) + [(0, 1)])
    return vpu.cond_sub(hi, n_pad)[..., :L]


@jax.jit
def mod_wide(ctx: MontCtx, x: jnp.ndarray) -> jnp.ndarray:
    """x mod n for a wide (up to 2L limbs) x < R*n."""
    L = ctx.n_limbs
    pad = 2 * L - x.shape[-1]
    if pad < 0:
        raise ValueError("mod_wide input wider than 2L limbs")
    if pad:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    return mont_mul(ctx, mont_reduce_wide(ctx, x),
                    jnp.broadcast_to(ctx.r2, x.shape[:-1] + (L,)))


@jax.jit
def mod_wide_any(ctx: MontCtx, x: jnp.ndarray) -> jnp.ndarray:
    """x mod n for x of any limb width (folds limbs above 2L first).

    Needed for RNS->limb outputs whose exact representatives live below
    M ~ 2^18 * n, a couple of limbs wider than n^2's 2L window.
    """
    L = ctx.n_limbs
    W = x.shape[-1]
    if W <= 2 * L:
        return mod_wide(ctx, x)
    hi = x[..., 2 * L:]                      # < 2^(16*(W-2L)), small
    lo = x[..., :2 * L]
    if W - 2 * L > L:
        raise ValueError("mod_wide_any: top part wider than L limbs")
    hi_pad = jnp.pad(hi, [(0, 0)] * (x.ndim - 1) + [(0, 3 * L - W)])
    # fold: x mod n == (hi * (2^(32L) mod n) + lo) mod n
    t = modmul(ctx, hi_pad, jnp.broadcast_to(ctx.b2l, hi_pad.shape))
    s, carry = vpu.add(lo, jnp.pad(t, [(0, 0)] * (t.ndim - 1) + [(0, L)]))
    # a wrapped sum means + 2^(32L), i.e. one more b2l term mod n
    extra = jnp.where(carry[..., None] != 0,
                      jnp.broadcast_to(ctx.b2l, s.shape[:-1] + (L,)),
                      jnp.zeros(s.shape[:-1] + (L,), jnp.uint32))
    red = mod_wide(ctx, s)
    red2, c2 = vpu.add(red, extra)
    wide = jnp.concatenate([red2, c2[..., None]], axis=-1)  # < 2n
    n_pad = jnp.pad(jnp.broadcast_to(ctx.n, red2.shape),
                    [(0, 0)] * (red2.ndim - 1) + [(0, 1)])
    return vpu.cond_sub(wide, n_pad)[..., :L]


# ---------------------------------------------------------------------------
# Fixed-window modular exponentiation
# ---------------------------------------------------------------------------

def exp_digits(e: int, window: int, n_digits: int) -> np.ndarray:
    """MSB-first base-2^window digits of e, padded to n_digits (host side)."""
    digits = []
    for i in range(n_digits - 1, -1, -1):
        digits.append((e >> (i * window)) & ((1 << window) - 1))
    return np.asarray(digits, dtype=np.int32)


def n_digits_for_bits(bits: int, window: int) -> int:
    return max(1, -(-bits // window))


def _build_table(ctx: MontCtx, bm: jnp.ndarray, window: int) -> jnp.ndarray:
    """[2^w, ..., L] table of powers bm^d in Montgomery form; entry 0 is 1."""
    entries = [jnp.broadcast_to(ctx.one_m, bm.shape), bm]
    for _ in range(2, 1 << window):
        entries.append(mont_mul(ctx, entries[-1], bm))
    return jnp.stack(entries, axis=0)


@partial(jax.jit, static_argnames=('window',))
def mont_pow_digits(ctx: MontCtx, base: jnp.ndarray, digits: jnp.ndarray,
                    window: int = 4) -> jnp.ndarray:
    """base^e mod n with e given as MSB-first base-2^w digits.

    ``digits`` is int32 of shape [D] (exponent shared across the batch) or
    [..., D] matching base's batch shape (per-element exponents).  Base is
    a normal (non-Montgomery) residue < n; result likewise.  The ladder is
    a lax.scan over the digits.
    """
    per_element = digits.ndim > 1
    bm = to_mont(ctx, base)
    tbl = _build_table(ctx, bm, window)   # [2^w, ..., L]

    def body(acc, d):
        for _ in range(window):
            acc = mont_mul(ctx, acc, acc)
        if per_element:
            # d: [...] int32 -> gather per batch element
            t = jnp.take_along_axis(
                tbl, d[None, ..., None].astype(jnp.int32), axis=0)[0]
        else:
            t = jnp.take(tbl, d, axis=0)
        return mont_mul(ctx, acc, t), None

    # tie the carry init to the data so varying-axis types match the scan
    # body output under shard_map
    acc0 = jnp.broadcast_to(ctx.one_m, bm.shape) + bm * jnp.uint32(0)
    if per_element:
        acc0 = acc0 + (digits[..., :1] * 0).astype(jnp.uint32)
    scan_digits = jnp.moveaxis(digits, -1, 0) if per_element else digits
    acc, _ = lax.scan(body, acc0, scan_digits)
    return from_mont(ctx, acc)


def mont_pow(ctx: MontCtx, base: jnp.ndarray, e: int, window: int = 4
             ) -> jnp.ndarray:
    """base^e mod n for a host-known nonnegative int exponent (shared)."""
    if e < 0:
        raise ValueError("negative exponents need a modular inverse")
    if e == 0:
        return jnp.broadcast_to(
            jnp.zeros_like(base).at[..., 0].set(1), base.shape)
    nd = n_digits_for_bits(e.bit_length(), window)
    return mont_pow_digits(
        ctx, base, jnp.asarray(exp_digits(e, window, nd)), window)


@partial(jax.jit, static_argnames=('window',))
def mont_pow_fixed_base(ctx: MontCtx, base_1d: jnp.ndarray,
                        digits: jnp.ndarray, window: int = 4
                        ) -> jnp.ndarray:
    """base^e_b mod n for a batch-shared base and per-element exponents.

    ``base_1d`` is a single residue [L]; ``digits`` is int32[..., D]
    (MSB-first base-2^w).  The power table is shared across the batch
    ([2^w, L]), so the gather per step is a cheap shared-table lookup —
    the fast path for Damgård-Jurik "alternative" encryption h^r
    (reference: paillier.go:221-238).
    """
    bm = to_mont(ctx, base_1d)
    tbl = _build_table(ctx, bm, window)     # [2^w, L]
    batch_shape = digits.shape[:-1]
    L = ctx.n_limbs

    def body(acc, d):
        for _ in range(window):
            acc = mont_mul(ctx, acc, acc)
        t = jnp.take(tbl, d, axis=0)        # [..., L]
        return mont_mul(ctx, acc, t), None

    acc0 = (jnp.broadcast_to(ctx.one_m, batch_shape + (L,))
            + (digits[..., :1] * 0).astype(jnp.uint32))
    acc, _ = lax.scan(body, acc0, jnp.moveaxis(digits, -1, 0))
    return from_mont(ctx, acc)


@partial(jax.jit, static_argnames=('window', 'n_digits'))
def limbs_to_digits(x: jnp.ndarray, window: int, n_digits: int | None = None
                    ) -> jnp.ndarray:
    """Device-side MSB-first base-2^w digits of a limb vector.

    ``window`` must divide LIMB_BITS.  Output is int32[..., D] with
    D = n_limbs * LIMB_BITS / window (or padded/truncated to n_digits),
    suitable for :func:`mont_pow_digits` — used when the exponent itself is
    a device value (e.g. NestedAdd raises ct1 to the power ct2.C,
    reference: operations.go:121-127).
    """
    if LIMB_BITS % window:
        raise ValueError("window must divide LIMB_BITS")
    per = LIMB_BITS // window
    # little-endian digit expansion of each limb, then flatten LE, then flip
    shifts = jnp.arange(per, dtype=jnp.uint32) * window
    mask = jnp.uint32((1 << window) - 1)
    d = (x[..., :, None] >> shifts) & mask          # [..., L, per] LE
    d = d.reshape(x.shape[:-1] + (x.shape[-1] * per,))  # LE digit string
    d = jnp.flip(d, axis=-1).astype(jnp.int32)      # MSB-first
    if n_digits is not None:
        D = d.shape[-1]
        if n_digits < D:
            d = d[..., D - n_digits:]
        elif n_digits > D:
            d = jnp.pad(d, [(0, 0)] * (d.ndim - 1) + [(n_digits - D, 0)])
    return d


# ---------------------------------------------------------------------------
# Exact division (Hensel) — used for Paillier's L(u, n) = (u-1)/n
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=('out_len',))
def exact_div(x: jnp.ndarray, d_inv: jnp.ndarray, out_len: int) -> jnp.ndarray:
    """x / d for exact divisions, via q = x * d^{-1} mod 2^(16*out_len).

    ``d_inv`` is the Hensel inverse of the (odd) divisor to at least
    out_len limbs (host.hensel_inverse).  Requires the true quotient to fit
    in out_len limbs.
    """
    return vpu.mul_low(x, d_inv, out_len)
