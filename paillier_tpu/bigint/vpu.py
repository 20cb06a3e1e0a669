"""Batched fixed-limb big-integer arithmetic as elementwise jnp ops.

This is the data-plane replacement for the reference's libgmp binding
(reference: github.com/ncw/gmp, imported at paillier.go:10) — redesigned
for batched devices instead of translated:

* Integers are little-endian radix-2^16 limb vectors in ``uint32`` lanes,
  shape ``(batch, n_limbs)``.  16-bit limbs keep limb products exact in
  uint32 (the widest exact elementwise integer multiply) and column sums
  of thousands of partial products still fit without overflow.
* The batch axis is the SIMD axis: every op is elementwise across lanes.
* Carry propagation is log-depth via ``lax.associative_scan`` (generate/
  propagate, Kogge-Stone style) rather than a sequential ripple.
* Multiplication is a length-L scan of broadcast multiply-accumulates
  (one scan step per multiplier limb), i.e. the operand-scanning half of
  CIOS, with carries resolved once at the end.

All functions are shape-polymorphic in batch and limb count and are
jit/vmap/shard_map friendly (static shapes, no data-dependent control
flow).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from functools import partial

from .host import LIMB_BITS, LIMB_MASK

_MASK = jnp.uint32(LIMB_MASK)
_BITS = LIMB_BITS


def _u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.uint32)


# ---------------------------------------------------------------------------
# Carry resolution: log-depth generate/propagate prefix scan
# ---------------------------------------------------------------------------

def _carry_combine(left, right):
    """Combine carry descriptors: (g, p) over limb ranges.

    g = range emits a carry-out of 1 regardless of carry-in,
    p = range propagates its carry-in.
    """
    g_l, p_l = left
    g_r, p_r = right
    return g_r | (p_r & g_l), p_l & p_r


def resolve_carries_01(s: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Resolve carries for limb values in [0, 2^17): returns (limbs, carry_out).

    ``s`` is uint32[..., L] with each entry < 2^17 (e.g. the lane-wise sum of
    two normalized numbers plus a possible +1).  Output limbs are < 2^16 and
    ``carry_out`` is the uint32[...] carry off the top limb.

    The (g, p) prefix runs as a hand-rolled Kogge-Stone ladder (log2 L
    static steps of vector ops) rather than ``lax.associative_scan`` so the
    same code path compiles inside Pallas kernels.
    """
    g = (s >> _BITS).astype(jnp.uint32)  # 0/1 generate
    r = s & _MASK
    p = (r == _MASK).astype(jnp.uint32)  # propagate
    L = s.shape[-1]

    def shift_right_k(x, k):
        # prefix shift along the limb axis: out[i] = x[i-k], zeros below
        pad = [(0, 0)] * (x.ndim - 1) + [(k, 0)]
        return jnp.pad(x, pad)[..., :L]

    d = 1
    while d < L:
        g = g | (p & shift_right_k(g, d))
        p = p & shift_right_k(p, d)
        d *= 2
    # g now holds the inclusive prefix: carry OUT of limb k
    carry_out = g[..., -1]
    carry_in = jnp.concatenate(
        [jnp.zeros_like(g[..., :1]), g[..., :-1]], axis=-1)
    out = (r + carry_in) & _MASK
    return out, carry_out


def normalize(cols: jnp.ndarray) -> jnp.ndarray:
    """Normalize unreduced column sums (each < 2^31) to limbs < 2^16.

    Two vectorized fold passes shrink entries to < 2^16 + 1, then one
    log-depth 0/1-carry resolution finishes exactly.  Any final carry off
    the top limb is dropped (callers size the output so it is zero).
    """
    v = cols
    for _ in range(2):
        lo = v & _MASK
        hi = v >> _BITS
        hi_shift = jnp.concatenate(
            [jnp.zeros_like(hi[..., :1]), hi[..., :-1]], axis=-1)
        v = lo + hi_shift
    out, _ = resolve_carries_01(v)
    return out


# ---------------------------------------------------------------------------
# Add / sub / compare
# ---------------------------------------------------------------------------

@jax.jit
def add(a: jnp.ndarray, b: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(a + b) of equal-width normalized numbers -> (limbs, carry_out)."""
    return resolve_carries_01(a + b)


@jax.jit
def sub(a: jnp.ndarray, b: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(a - b) mod 2^(16L) -> (limbs, borrow) with borrow=1 iff a < b."""
    # two's complement add: a + ~b + 1 over 16-bit limbs
    s = a + (b ^ _MASK)
    s = s.at[..., 0].add(1)
    out, carry = resolve_carries_01(s)
    return out, jnp.uint32(1) - carry


@jax.jit
def geq(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a >= b elementwise over the batch -> bool[...]."""
    _, borrow = sub(a, b)
    return borrow == 0


@jax.jit
def cond_sub(a: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """a - n where a >= n else a (branchless). Shapes must match."""
    d, borrow = sub(a, n)
    return jnp.where((borrow == 0)[..., None], d, a)


@jax.jit
def is_zero(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.all(a == 0, axis=-1)


@jax.jit
def eq(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.all(a == b, axis=-1)


# ---------------------------------------------------------------------------
# Multiplication
# ---------------------------------------------------------------------------

def _mul_cols(a: jnp.ndarray, b: jnp.ndarray, out_len: int) -> jnp.ndarray:
    """Unnormalized column sums of the product a*b, truncated to out_len limbs.

    a: uint32[..., La] normalized; b: uint32[..., Lb] normalized (or
    broadcastable, e.g. a shared [Lb] operand).  Horner form over the limbs
    of ``a`` (MSB first): each scan step shifts the accumulator one limb
    left (a static concat — no dynamic indexing) and adds a_i * b split
    into 16-bit halves.  Column entries stay < 2^17 * min(La, Lb) <= 2^31
    for limb counts <= 2^14, so no intermediate carries are needed.
    """
    La = a.shape[-1]
    b = jnp.broadcast_to(b, a.shape[:-1] + (b.shape[-1],))
    Lb = min(b.shape[-1], out_len)
    b = b[..., :Lb]
    batch_shape = a.shape[:-1]
    # initialize the carry FROM the inputs (x*0) so its sharding/varying
    # type matches the scan body's output under shard_map
    tie = (a[..., :1] * jnp.uint32(0)) + (b[..., :1] * jnp.uint32(0))
    acc = jnp.zeros(batch_shape + (out_len,), dtype=jnp.uint32) + tie
    zero_limb = jnp.zeros(batch_shape + (1,), dtype=jnp.uint32) + tie

    # [La, ...] MSB-first stream of a's limbs
    a_stream = jnp.moveaxis(jnp.flip(a, axis=-1), -1, 0)

    def body(acc, ai):
        acc = jnp.concatenate([zero_limb, acc[..., :-1]], axis=-1)  # * 2^16
        p = ai[..., None] * b                                       # exact
        acc = acc.at[..., :Lb].add(p & _MASK)
        if Lb < out_len:
            acc = acc.at[..., 1:Lb + 1].add(p >> _BITS)
        else:
            acc = acc.at[..., 1:Lb].add((p >> _BITS)[..., :Lb - 1])
        return acc, None

    acc, _ = lax.scan(body, acc, a_stream)
    return acc


@partial(jax.jit, static_argnames=('out_len',))
def mul(a: jnp.ndarray, b: jnp.ndarray, out_len: int | None = None
        ) -> jnp.ndarray:
    """Full product of normalized numbers; default width La+Lb limbs."""
    if out_len is None:
        out_len = a.shape[-1] + b.shape[-1]
    return normalize(_mul_cols(a, b, out_len))


@partial(jax.jit, static_argnames=('out_len',))
def mul_low(a: jnp.ndarray, b: jnp.ndarray, out_len: int) -> jnp.ndarray:
    """Low ``out_len`` limbs of a*b, i.e. a*b mod 2^(16*out_len)."""
    return normalize(_mul_cols(a, b, out_len))


def shift_limbs_right(a: jnp.ndarray, k: int) -> jnp.ndarray:
    """a // 2^(16k) (drop low k limbs, keep width)."""
    pad = [(0, 0)] * (a.ndim - 1) + [(0, k)]
    return jnp.pad(a[..., k:], pad)
