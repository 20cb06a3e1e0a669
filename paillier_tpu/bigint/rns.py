"""RNS (residue number system) Montgomery arithmetic — the v1 engine.

The limb-vector ladders (montgomery.py) cost O(L^2) serial elementwise
ops per modmul (schoolbook multiplication).  This module replaces them
with the Cox-Rower / Bajard-Imbert RNS design used by hardware RSA
engines, mapped onto matrix units:

* Numbers live as residues modulo ~300 14-bit prime channels per base
  (two bases B1, B2 + one redundant channel).  A modular multiplication
  is O(channels) *pointwise* work plus two *base extensions* —
  matrix products against fixed CRT matrices — which run as
  exact bf16 x bf16 -> f32 matmuls (7-bit operand chunks keep every
  product and partial sum exactly representable).
* Per-channel products use channel-level Montgomery with R = 2^16 so all
  intermediate scalars stay exact in uint32 lanes.
* The first base extension is approximate (Bajard-Imbert: the alpha*M
  excess is absorbed by the value-range invariant values < (k+1)N with
  M >= (k+1)^2 N); the second uses the Shenoy-Kumaresan redundant-channel
  correction and is exact.

References (techniques, all public literature): Kawamura et al.,
"Cox-Rower Architecture for Fast Parallel Montgomery Multiplication"
(EUROCRYPT 2000); Bajard & Imbert, "A full RNS implementation of RSA";
Shenoy & Kumaresan, "Fast base extension using a redundant modulus".

Replaces the gmp.Int.Exp hot path of the reference (paillier.go:213-216)
at production key sizes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import host

CHANNEL_BITS = 14          # moduli are primes in (2^13, 2^14)
CHUNK = 7                  # matmul operand chunk width (bf16-exact)
_R16 = 1 << 16             # per-channel Montgomery radix


def _primes_below_14bit(count: int) -> list[int]:
    """Descending primes < 2^14 (largest first maximizes channel width).

    Extends below 2^13 when large moduli need more channels — every bound
    in this module only requires m < 2^14 (7-bit chunks, uint32 products).
    """
    out = []
    n = (1 << CHANNEL_BITS) - 1
    while len(out) < count and n > 3:
        if host.is_probable_prime(n, 12):
            out.append(n)
        n -= 2
    if len(out) < count:
        raise ValueError("not enough sub-14-bit primes for the requested size")
    return out


class RnsContext(NamedTuple):
    """Device constants for RNS Montgomery arithmetic modulo N.

    Channel layout: [0:k] base B1, [k:2k] base B2, [2k] redundant m_r.
    """

    # per-channel uint32 vectors [C]
    m: jax.Array            # channel moduli
    mprime: jax.Array       # -m^{-1} mod 2^16
    inv_m_f32: jax.Array    # 1/m as f32 (for float reduction)
    k1_const: jax.Array     # B1: (-N^{-1} (M/m_i)^{-1}) mod m_i, else 0
    c1_const: jax.Array     # B2+r: M^{-1} 2^16 mod m_j, else 0
    c2_const: jax.Array     # B2+r: N M^{-1} 2^32 mod m_j, else 0
    k3_const: jax.Array     # B2: (M2/m_j)^{-1} mod m_j, else 0
    m2mod: jax.Array        # B1: M2 mod m_i, else 0
    r2_chan: jax.Array      # 2^32 mod m (to channel-Mont form)
    # matmul matrices, bf16, chunk-stacked: [2k, 2*cols]
    ext1: jax.Array         # B1 -> B2+r extension  [2k1, 2*(k2+1)]
    ext2: jax.Array         # B2 -> B1+r extension  [2k2, 2*(k1+1)]
    # extension targets
    ext2_m: jax.Array       # [k+1] = B1 moduli + m_r
    ext2_inv: jax.Array     # f32 reciprocals of ext2_m
    # redundant-channel scalars
    m2inv_r_mont: jax.Array  # (M2^{-1} << 16) mod m_r, uint32
    m_r: jax.Array           # m_r scalar uint32

    @property
    def k(self) -> int:
        return self.ext1.shape[0] // 2

    @property
    def channels(self) -> int:
        return self.m.shape[0]


class RnsSpec:
    """Host-side companion: python-int moduli and CRT data for encode /
    decode, plus the Montgomery-domain entry factor."""

    def __init__(self, n_modulus: int):
        self.N = n_modulus
        nbits = n_modulus.bit_length()
        # choose k so that M = prod(B1) >= (k+1)^2 * N  (range closure)
        k = (nbits + 24) // (CHANNEL_BITS - 1)
        primes = _primes_below_14bit(2 * k + 64)
        while True:
            if 2 * k + 1 > len(primes):
                primes = _primes_below_14bit(2 * k + 128)
            b1 = primes[:k]
            M = 1
            for p in b1:
                M *= p
            if M >= (k + 1) * (k + 1) * n_modulus:
                break
            k += 1
        self.k = k
        self.b1 = primes[:k]
        self.b2 = primes[k:2 * k]
        self.m_r = primes[2 * k]
        self.all_m = self.b1 + self.b2 + [self.m_r]
        self.M = 1
        for p in self.b1:
            self.M *= p
        self.M2 = 1
        for p in self.b2:
            self.M2 *= p
        if self.M2 < (k + 1) * n_modulus:
            raise ValueError("second base too small")
        # CRT reconstruction data over B1
        self.crt_w = [(self.M // p, pow(self.M // p, -1, p) % p)
                      for p in self.b1]
        # Montgomery-domain entry: x -> x*M mod N via mont_mul(x, M^2 mod N)
        self.m2_mod_n = (self.M * self.M) % n_modulus

    # -- host <-> residues -------------------------------------------------
    def encode(self, values: Sequence[int]) -> np.ndarray:
        """ints -> channel-Montgomery residues uint32[B, C]."""
        C = len(self.all_m)
        out = np.zeros((len(values), C), dtype=np.uint32)
        for b, v in enumerate(values):
            for i, m in enumerate(self.all_m):
                out[b, i] = ((v % m) << 16) % m
        return out

    def decode(self, residues: np.ndarray) -> list[int]:
        """channel-Montgomery residues -> ints mod N (CRT over B1)."""
        res = np.asarray(residues, dtype=np.uint64)
        inv_r16 = [pow(_R16, -1, m) for m in self.b1]
        out = []
        for b in range(res.shape[0]):
            x = 0
            for i, m in enumerate(self.b1):
                xi = (int(res[b, i]) * inv_r16[i]) % m
                Mi, wi = self.crt_w[i]
                x += ((xi * wi) % m) * Mi
            out.append((x % self.M) % self.N)
        return out

    # -- device context ----------------------------------------------------
    def build_context(self) -> RnsContext:
        N = self.N
        k = self.k
        b1, b2, m_r = self.b1, self.b2, self.m_r
        all_m = self.all_m
        C = len(all_m)

        m = np.asarray(all_m, dtype=np.uint32)
        mprime = np.asarray([(-pow(mi, -1, _R16)) % _R16 for mi in all_m],
                            dtype=np.uint32)
        inv_m = (1.0 / m.astype(np.float64)).astype(np.float32)

        k1c = np.zeros(C, np.uint32)
        for i, mi in enumerate(b1):
            k1c[i] = (pow(-N, -1, mi) * pow(self.M // mi, -1, mi)) % mi
        c1c = np.zeros(C, np.uint32)
        c2c = np.zeros(C, np.uint32)
        for j, mj in enumerate(b2 + [m_r]):
            idx = k + j
            minv = pow(self.M, -1, mj)
            c1c[idx] = (minv << 16) % mj
            c2c[idx] = (N * minv * (1 << 32)) % mj
        k3c = np.zeros(C, np.uint32)
        for j, mj in enumerate(b2):
            k3c[k + j] = pow(self.M2 // mj, -1, mj)
        m2m = np.zeros(C, np.uint32)
        for i, mi in enumerate(b1):
            m2m[i] = self.M2 % mi
        r2c = np.asarray([(1 << 32) % mi for mi in all_m], dtype=np.uint32)

        def chunk_stack(T: np.ndarray, target_m: np.ndarray) -> np.ndarray:
            """[rows, cols] uint matrix -> bf16 [2*rows, 2*cols] where the
            row blocks are the (lo7, hi7) chunks of (T, 2^7 T mod m)."""
            A0 = T % target_m[None, :]
            A1 = (T << CHUNK) % target_m[None, :]
            # lhs chunks multiply [A0; A1]; rhs col blocks are (lo, hi)
            top = np.concatenate([A0 & ((1 << CHUNK) - 1), A0 >> CHUNK],
                                 axis=1)
            bot = np.concatenate([A1 & ((1 << CHUNK) - 1), A1 >> CHUNK],
                                 axis=1)
            return np.concatenate([top, bot], axis=0)

        # ext1: B1 -> B2 + r:  T1[i, j] = (M/m_i) mod target_j
        targets1 = np.asarray(b2 + [m_r], dtype=np.uint64)
        T1 = np.zeros((k, k + 1), dtype=np.uint64)
        for i, mi in enumerate(b1):
            Mi = self.M // mi
            for j, mj in enumerate(b2 + [m_r]):
                T1[i, j] = Mi % mj
        ext1 = chunk_stack(T1, targets1)

        # ext2: B2 -> B1 + r:  T2[j, i] = (M2/m'_j) mod target_i
        targets2 = np.asarray(b1 + [m_r], dtype=np.uint64)
        T2 = np.zeros((k, k + 1), dtype=np.uint64)
        for j, mj in enumerate(b2):
            Mj = self.M2 // mj
            for i, mi in enumerate(b1 + [m_r]):
                T2[j, i] = Mj % mi
        ext2 = chunk_stack(T2, targets2)

        ext2_m = np.asarray(b1 + [m_r], dtype=np.uint32)
        return RnsContext(
            m=jnp.asarray(m), mprime=jnp.asarray(mprime),
            inv_m_f32=jnp.asarray(inv_m),
            k1_const=jnp.asarray(k1c), c1_const=jnp.asarray(c1c),
            c2_const=jnp.asarray(c2c), k3_const=jnp.asarray(k3c),
            m2mod=jnp.asarray(m2m), r2_chan=jnp.asarray(r2c),
            ext1=jnp.asarray(ext1.astype(np.float32), dtype=jnp.bfloat16),
            ext2=jnp.asarray(ext2.astype(np.float32), dtype=jnp.bfloat16),
            ext2_m=jnp.asarray(ext2_m),
            ext2_inv=jnp.asarray(
                (1.0 / ext2_m.astype(np.float64)).astype(np.float32)),
            m2inv_r_mont=jnp.uint32((pow(self.M2, -1, m_r) << 16) % m_r),
            m_r=jnp.uint32(m_r),
        )


# ---------------------------------------------------------------------------
# Device pointwise primitives
# ---------------------------------------------------------------------------

def _cmul(x, y, m, mp):
    """Exact per-channel Montgomery product: x*y*2^-16 mod m.

    x, y < 2^16 (residues < m < 2^14 or 16-bit constants); all
    intermediates exact in uint32.
    """
    p = x * y
    plo = p & 0xFFFF
    u = (plo * mp) & 0xFFFF
    t = plo + u * m
    v = (p >> 16) + (t >> 16)
    return jnp.where(v >= m, v - m, v)


def _reduce_f32(v, m, inv_m):
    """Exact v mod m for int32 v in [0, 2^31), m < 2^14, via two float
    quotient passes + final conditional fixes."""
    vf = v.astype(jnp.float32)
    q = jnp.floor(vf * inv_m).astype(jnp.int32)
    r = v - q * m.astype(jnp.int32)                 # |r| < ~2m + slop
    r2 = r - jnp.floor(r.astype(jnp.float32) * inv_m).astype(jnp.int32) \
        * m.astype(jnp.int32)
    r2 = jnp.where(r2 < 0, r2 + m.astype(jnp.int32), r2)
    r2 = jnp.where(r2 >= m.astype(jnp.int32), r2 - m.astype(jnp.int32), r2)
    return r2.astype(jnp.uint32)


def _chunks_bf16(x):
    """uint32 residues < 2^14 -> bf16 [., 2k] (lo7 | hi7)."""
    lo = (x & ((1 << CHUNK) - 1)).astype(jnp.bfloat16)
    hi = (x >> CHUNK).astype(jnp.bfloat16)
    return jnp.concatenate([lo, hi], axis=-1)


def _extend(xi, ext_matrix, target_m, target_inv):
    """Base extension: exact Sum_i xi_i * T[i, j] mod m_j via one bf16
    matmul of chunk-stacked operands."""
    lhs = _chunks_bf16(xi)                                   # [B, 2k]
    P = lax.dot_general(lhs, ext_matrix, (((lhs.ndim - 1,), (0,)), ((), ())),
                        preferred_element_type=jnp.float32)  # [B, 2cols]
    cols = P.shape[-1] // 2
    v = P[..., :cols].astype(jnp.int32) + (
        P[..., cols:].astype(jnp.int32) << CHUNK)
    return _reduce_f32(v, target_m, target_inv)


# ---------------------------------------------------------------------------
# RNS Montgomery multiply
# ---------------------------------------------------------------------------

@jax.jit
def rns_mont_mul(ctx: RnsContext, x: jnp.ndarray, y: jnp.ndarray
                 ) -> jnp.ndarray:
    """w = x*y*M^{-1} mod N on channel-Montgomery residue vectors [B, C].

    Maintains the invariant value < (k+1)N.
    """
    k = ctx.k
    m, mp = ctx.m, ctx.mprime
    s = _cmul(x, y, m, mp)                                   # all channels

    # xi_i = s * (-N^{-1}) * (M/m_i)^{-1} mod m_i   (standard form, B1)
    xi = _cmul(s[..., :k], ctx.k1_const[:k], m[:k], mp[:k])

    # approximate extension of q to B2 + r (alpha*M excess tolerated)
    tgt_m = ctx.m[k:]
    tgt_inv = ctx.inv_m_f32[k:]
    Q = _extend(xi, ctx.ext1, tgt_m, tgt_inv)                # [B, k+1]

    # w = (s + Q N) M^{-1} mod m  on B2 + r (channel-Mont form)
    t1 = _cmul(s[..., k:], ctx.c1_const[k:], tgt_m, ctx.mprime[k:])
    t2 = _cmul(Q, ctx.c2_const[k:], tgt_m, ctx.mprime[k:])
    w2 = t1 + t2
    w2 = jnp.where(w2 >= tgt_m, w2 - tgt_m, w2)              # [B, k+1]

    # exact extension back to B1 (Shenoy, redundant channel)
    xi2 = _cmul(w2[..., :k], ctx.k3_const[k:2 * k], ctx.m[k:2 * k],
                ctx.mprime[k:2 * k])                         # standard, B2
    V = _extend(xi2, ctx.ext2, ctx.ext2_m, ctx.ext2_inv)     # [B, k+1]
    # alpha2 from the redundant channel: (V_r - w_r) * M2^{-1} mod m_r
    w_r_std = _cmul(w2[..., k:k + 1], jnp.uint32(1),
                    ctx.m_r, ctx.mprime[2 * k])
    diff = V[..., k:k + 1] + ctx.m_r - w_r_std
    diff = jnp.where(diff >= ctx.m_r, diff - ctx.m_r, diff)
    alpha2 = _cmul(diff, ctx.m2inv_r_mont, ctx.m_r, ctx.mprime[2 * k])

    # w_i = (V_i - alpha2 * (M2 mod m_i)) mod m_i  on B1 (standard form)
    sub = _reduce_f32((alpha2 * ctx.m2mod[:k]).astype(jnp.int32),
                      ctx.m[:k], ctx.inv_m_f32[:k])
    w1 = V[..., :k] + ctx.m[:k] - sub
    w1 = jnp.where(w1 >= ctx.m[:k], w1 - ctx.m[:k], w1)
    # to channel-Mont form
    w1 = _cmul(w1, ctx.r2_chan[:k], ctx.m[:k], ctx.mprime[:k])

    return jnp.concatenate([w1, w2], axis=-1)


# ---------------------------------------------------------------------------
# Windowed exponentiation over RNS residues
# ---------------------------------------------------------------------------

class RnsEngine:
    """User-facing engine bundling spec + context + cached constants."""

    def __init__(self, n_modulus: int):
        self.spec = RnsSpec(n_modulus)
        self.ctx = self.spec.build_context()
        self.m2_rns = jnp.asarray(self.spec.encode([self.spec.m2_mod_n])[0])
        self.one_rns = jnp.asarray(self.spec.encode([1])[0])
        self.mmodn_rns = jnp.asarray(
            self.spec.encode([self.spec.M % n_modulus])[0])

    def encode(self, values) -> jnp.ndarray:
        return jnp.asarray(self.spec.encode(list(values)))

    def decode(self, residues) -> list:
        return self.spec.decode(np.asarray(jax.device_get(residues)))

    def mont_mul(self, x, y):
        return rns_mont_mul(self.ctx, x, y)

    def pow(self, x, digits, window: int = 4):
        """x^e mod N (residues in, residues out; result value < (k+1)N)."""
        return _rns_pow(self.ctx, self.m2_rns, self.one_rns, self.mmodn_rns,
                        x, digits, window)


@functools.partial(jax.jit, static_argnames=("window",))
def _rns_pow(ctx: RnsContext, m2_rns, one_rns, mmodn_rns, x, digits,
             window: int = 4):
    per_element = digits.ndim > 1
    xm = rns_mont_mul(ctx, x, jnp.broadcast_to(m2_rns, x.shape))
    one_m = jnp.broadcast_to(mmodn_rns, x.shape)   # 1 in mont domain = M

    entries = [one_m, xm]
    for _ in range(2, 1 << window):
        entries.append(rns_mont_mul(ctx, entries[-1], xm))
    tbl = jnp.stack(entries, axis=0)

    def body(acc, d):
        for _ in range(window):
            acc = rns_mont_mul(ctx, acc, acc)
        if per_element:
            t = jnp.take_along_axis(
                tbl, d[None, ..., None].astype(jnp.int32), axis=0)[0]
        else:
            t = jnp.take(tbl, d, axis=0)
        return rns_mont_mul(ctx, acc, t), None

    acc, _ = lax.scan(body, one_m,
                      jnp.moveaxis(digits, -1, 0) if per_element else digits)
    return rns_mont_mul(ctx, acc, jnp.broadcast_to(one_rns, x.shape))


# ---------------------------------------------------------------------------
# Device-side limb <-> RNS conversions
# ---------------------------------------------------------------------------

class RnsConverter:
    """Bidirectional converter between radix-2^16 limb vectors and RNS
    residues, all on device.

    limbs -> residues: one exact bf16 matmul against the chunk-stacked
    power matrix P[l, i] = 2^(16 l) mod m_i (three 7-bit row chunks for
    the 16-bit limbs, two 7-bit column chunks for the 14-bit entries),
    then per-channel reduction.

    residues -> limbs: eta_i = x_i * (M/m_i)^{-1} mod m_i pointwise, then
    one matmul against the limb decompositions of (M/m_i) (two row
    chunks, three column chunks for 16-bit limbs); the alpha*M overshoot
    (x = sum - alpha*M) is fixed exactly with a float estimate of
    sum(eta_i/m_i) plus conditional +-M limb corrections.
    """

    def __init__(self, eng: "RnsEngine", n_limbs: int):
        spec = eng.spec
        self.eng = eng
        self.L = n_limbs
        k = spec.k
        C = len(spec.all_m)
        mask7 = (1 << CHUNK) - 1

        # forward: P[l, i] = 2^(16 l) mod m_i; rows for limb chunks
        # (1, 2^7, 2^14) folded into shifted matrices, columns split lo/hi.
        P = np.zeros((n_limbs, C), dtype=np.uint64)
        for i, mi in enumerate(spec.all_m):
            val = 1 % mi
            step = pow(2, 16, mi)
            for l in range(n_limbs):
                P[l, i] = val
                val = (val * step) % mi
        row_blocks = []
        for shift in (0, CHUNK, 2 * CHUNK):
            A = (P << shift).copy()
            for i, mi in enumerate(spec.all_m):
                A[:, i] %= mi
            row_blocks.append(
                np.concatenate([A & mask7, A >> CHUNK], axis=1))
        self.fwd = jnp.asarray(
            np.concatenate(row_blocks, axis=0).astype(np.float32),
            dtype=jnp.bfloat16)

        # reverse: limbs of (M/m_i) over B1; rows for eta chunks (1, 2^7)
        # re-decomposed exactly, columns split into three 7-bit chunks.
        ML = max(n_limbs, (spec.M.bit_length() + 15) // 16)
        self.ML = ML
        row_blocks = []
        for shift in (0, CHUNK):
            W = np.zeros((k, ML), dtype=np.uint64)
            for i, mi in enumerate(spec.b1):
                W[i] = host.int_to_limbs((spec.M // mi) << shift, ML
                                         ).astype(np.uint64)
            row_blocks.append(np.concatenate(
                [W & mask7, (W >> CHUNK) & mask7, W >> (2 * CHUNK)], axis=1))
        self.rev = jnp.asarray(
            np.concatenate(row_blocks, axis=0).astype(np.float32),
            dtype=jnp.bfloat16)

        w1 = np.zeros(C, np.uint32)
        for i, mi in enumerate(spec.b1):
            w1[i] = pow(spec.M // mi, -1, mi)
        self.w1 = jnp.asarray(w1)
        self.inv_m_b1_f32 = jnp.asarray(
            (1.0 / np.asarray(spec.b1, dtype=np.float64)).astype(np.float32))
        self.M_limbs = jnp.asarray(host.int_to_limbs(spec.M, ML))

    def from_limbs(self, x: jnp.ndarray) -> jnp.ndarray:
        """uint32[B, L] limbs -> channel-Montgomery residues [B, C]."""
        return _from_limbs_jit(self.eng.ctx, self.fwd, x)

    def to_limbs(self, x: jnp.ndarray) -> jnp.ndarray:
        """channel-Montgomery residues [B, C] -> limbs [B, ML] of the
        exact value (< M)."""
        return _to_limbs_jit(self.eng.ctx, self.rev, self.w1,
                             self.inv_m_b1_f32, self.M_limbs, x)


@jax.jit
def _from_limbs_jit(ctx: RnsContext, fwd, x):
    mask7 = (1 << CHUNK) - 1
    c0 = (x & mask7).astype(jnp.bfloat16)
    c1 = ((x >> CHUNK) & mask7).astype(jnp.bfloat16)
    c2 = (x >> (2 * CHUNK)).astype(jnp.bfloat16)
    lhs = jnp.concatenate([c0, c1, c2], axis=-1)
    P = lax.dot_general(lhs, fwd, (((lhs.ndim - 1,), (0,)), ((), ())),
                        preferred_element_type=jnp.float32)
    cols = P.shape[-1] // 2
    v = P[..., :cols].astype(jnp.int32) + (
        P[..., cols:].astype(jnp.int32) << CHUNK)
    std = _reduce_f32(v, ctx.m, ctx.inv_m_f32)
    return _cmul(std, ctx.r2_chan, ctx.m, ctx.mprime)


@jax.jit
def _to_limbs_jit(ctx: RnsContext, rev, w1, inv_b1, M_limbs, x):
    from . import vpu
    k = ctx.k
    mask7 = (1 << CHUNK) - 1
    # eta_i = x_i * w1_i (standard form; _cmul removes the 2^16 factor)
    eta = _cmul(x[..., :k], w1[:k], ctx.m[:k], ctx.mprime[:k])
    lo = (eta & mask7).astype(jnp.bfloat16)
    hi = (eta >> CHUNK).astype(jnp.bfloat16)
    lhs = jnp.concatenate([lo, hi], axis=-1)
    P = lax.dot_general(lhs, rev, (((lhs.ndim - 1,), (0,)), ((), ())),
                        preferred_element_type=jnp.float32)
    ML = P.shape[-1] // 3
    cols = (P[..., :ML].astype(jnp.uint32)
            + (P[..., ML:2 * ML].astype(jnp.uint32) << CHUNK)
            + (P[..., 2 * ML:].astype(jnp.uint32) << (2 * CHUNK)))
    total = vpu.normalize(cols)                        # limbs of sum eta*Mi
    # alpha = floor(sum eta_i / m_i), float estimate then exact fixup
    frac = jnp.sum(eta.astype(jnp.float32) * inv_b1, axis=-1)
    alpha = jnp.floor(frac + 0.5**12).astype(jnp.uint32)   # off by <= 1
    aM = vpu.mul(alpha[..., None], M_limbs, ML)
    cand, borrow = vpu.sub(total, aM)
    # borrow -> alpha overshot by one: add M back
    fixed_up, _ = vpu.add(cand, jnp.broadcast_to(M_limbs, cand.shape))
    cand = jnp.where(borrow[..., None] != 0, fixed_up, cand)
    # alpha may have undershot: subtract M while >= M
    cand = vpu.cond_sub(cand, jnp.broadcast_to(M_limbs, cand.shape))
    return cand
