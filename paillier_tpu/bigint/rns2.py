"""RNS Montgomery engine v2 — int8 matrix products, Cox-Rower.

Second-generation Cox-Rower engine (supersedes :mod:`rns.py` on the hot
paths).  Design points:

* **Standard-form residues** (no per-channel Montgomery factor): every
  per-channel constant multiply is *folded into the base-extension
  matrices*, so a full RNS Montgomery multiplication needs only ONE
  variable-by-variable integer multiply per channel; everything else is
  int8 matmuls plus float-reciprocal channel reductions.
* **Sigma-form B2 half**: B2 residues are stored pre-scaled by
  c_j = (M2/m'_j)^-1, i.e. the stored value IS the Kawamura digit of
  the true residue, which deletes one multiply and one exact reduction
  per Montgomery multiply (see the ic2 block comment).  B1 stays in
  true form; decode/to_limbs read only B1.
* **int8 matmul path**: extension matrices are stored as 7-bit chunk
  pairs in int8; ``i8 x i8 -> i32`` dots make every accumulation exact
  in int32 (no 2^24 float-exactness cliff).
* **Cox floating alpha for the second extension** (Kawamura et al.,
  EUROCRYPT 2000) replaces the Shenoy redundant channel: alpha2 =
  floor(sum(sigma_j / m'_j) + eps), exact because M2 >= 8*lambda*N keeps
  the true fraction below 1/8 while the f32 sum error, bounded for any
  summation order, stays below eps (checked per spec in Rns2Spec).
* **Per-base array layout**: residues live as a pair of [batch, k]
  arrays (base B1 / base B2).  Each base extension is ONE merged
  ``[B, 2k] x [2k, 2*pk]`` int8 dot (lo-chunk columns at 0, hi-chunk
  columns at pk, zero gaps between).
* **Ladders are XLA programs**: every exponentiation is a ``lax.scan``
  over exponent digits (or a sliding-window schedule) around the
  Montgomery multiply below, compiled by XLA for the backend in use.

Value-range invariants (signed-lazy configuration): channel primes
< MCAP, k per base.  Ladder (lazy) residues are SIGNED near-canonical:
digit outputs (_red_fast) live in (-(m + ~820), m + ~820) and residue
outputs (_red_lazy) in (-m, 2m); the final lazy=False multiply returns
canonical [0, m).  Two-chunk matrix folding inflates first-extension
digits to < 2^22, so alpha1 < k*2^9.5; inputs/outputs of the Montgomery
multiply stay below lambda*N in magnitude with lambda = k*2^10.  The
spec enforces M >= lambda^2 * N (first base) and M2 >= 8*lambda*N —
the latter both caps the true cox fraction at 1/8 AND caps the signed
digit-inflation drift |t|*N/M2 <= 1/32 that COX_EPS must dominate
(see COX_EPS below; checked in Rns2Spec.__init__).

Replaces the reference's gmp.Int.Exp hot path (reference:
paillier.go:213-216, 296; thresholdkey.go:195-199; ddleq.go:81-87).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import host

CHUNK = 7                      # int8 chunk width (values < 2^7)
# Channel prime cap for the fast-reduction ladder path: _red_fast digit
# outputs live in (-(m + RED_BIAS_INT + ~396), m + RED_BIAS_INT + ~396)
# and must still chunk into two int8 7-bit digits, i.e. |digit| < 2^14:
# 15200 + 420 + 396 = 16016 < 16384, hi chunk in [-126, 125].  The bias
# is an *absolute* pre-subtraction because the f32 quotient error in
# units of m is m-independent: delta*m <= ~3.5*VMAX*2^-24 ~= 396 with
# VMAX = 1.9e9, the widest red input (v + t1 in _mm_lhs2) — leaving a
# 420 - 396 = 24 margin under RED_BIAS_INT.
MCAP = 15200
RED_BIAS_INT = 420

# ic1 rows (base B1 constants, int32 [NI1, k])
I1_M = 0       # B1 moduli
I1_M2M = 1     # m_i - (M2 mod m_i): the cox correction is ADDED (keeps
               # the pre-reduction value nonneg so trunc-reds suffice)
I1_ENTRY = 2   # (M^2 mod N) mod m_i  (to-Montgomery factor)
I1_ONEM = 3    # (M mod N) mod m_i    (1 in Montgomery form)
I1_ONE = 4     # 1
NI1 = 5

# ic2 rows (base B2 constants, int32 [NI2, k]).
#
# SIGMA-FORM B2 REPRESENTATION: every B2 residue is stored
# pre-scaled by c_j = (M2/m'_j)^-1 mod m'_j — i.e. the stored value IS
# the Kawamura digit sigma_j = w*c_j mod m'_j of the true residue w.
# The second base extension needs exactly these digits, so storing them
# directly deletes one int32 multiply (w*c) and one exact reduction
# from EVERY Montgomery multiply's hot path.  The scaling is absorbed
# into constants for free: the ext1 matrix columns and the U0 row carry
# an extra c_j factor, the entry/one constant rows are stored scaled,
# and the limb->residue converter scales its B2 columns.  Decode,
# to_limbs and the CRT weights read only B1, which stays in true form.
I2_M = 0       # B2 moduli
I2_U0S = 1     # (M^-1 * c_j^-1) mod m'_j  (sigma-form Montgomery factor)
I2_ENTRY = 2   # sigma-form (M^2 mod N) mod m'_j
I2_ONEM = 3    # sigma-form (M mod N) mod m'_j
I2_ONE = 4     # sigma-form 1
NI2 = 5

# Cox bias.  With the signed lazy digit mix (_red_fast on possibly
# negative inputs) the B2 digit vector sg represents w + t*M2' where the
# underlying integer drift t can be NEGATIVE, so the cox fraction can
# sit just BELOW an integer.  floor(sum + COX_EPS) is exact iff
#   COX_EPS > drift + err   and   1/8 + drift + err + COX_EPS < 1,
# with drift = max|t| * N / M2 and err the f32 error of the alpha sum.
# Per-channel deviation bound (derived from the actual _red_fast/ext1
# ranges, not the optimistic 2^7): the first-extension digit combine
# inflates per-channel values to < 2^22, i.e. < 2^8.2 units of
# m'_j ~ 2^13.9, and the _red_fast bias adds < 1 more unit — bounded by
# 2^8 per channel after the digit reduction re-centers, so |t| <= k*2^8
# and drift <= k*2^8*N/M2 <= 2^8/(8*2^10) = 1/32 (from M2 >= 8*lambda*N,
# lambda = k*2^10).  err is bounded for ANY summation order (XLA picks
# the reduction order per backend): see _cox_sum_error.  The two
# conditions leave eps the interval (drift + err, 7/8 - drift - err),
# whose centre is 7/16 for every spec; at k=640 err reaches ~0.07, which
# an eps just above the drift would not cover.  Checked against the
# concrete spec in Rns2Spec.__init__ (a real exception, not an assert —
# the guard protects against silent numerical corruption and must
# survive -O).
COX_EPS = 7 / 16


def _cox_sum_error(b2: Sequence[int]) -> float:
    """Order-independent bound on the f32 error of the cox alpha sum
    sum_j fl(sg_j * fl(1/m'_j)) + COX_EPS over the k channels of ``b2``.

    With u = 2^-24, |sg_j| < 2^14 (exact in f32) and e_j = sg_j/m'_j:
    rounding 1/m'_j and the product cost <= 2u|e_j| per term, any
    summation order of k terms adds <= (k-1)u * sum|e_j|, and adding
    COX_EPS one more u * sum|e_j|: (k+2)u * sum_j 2^14/m'_j in total
    (x1.01 covers the second-order terms)."""
    k = len(b2)
    return 1.01 * (k + 2) * 2.0 ** -24 * sum((1 << 14) / m for m in b2)


def _primes_descending(count: int) -> list[int]:
    """``count`` largest primes below MCAP (descending)."""
    out = []
    n = MCAP - 1 if MCAP % 2 == 0 else MCAP
    while len(out) < count and n > (1 << 11):
        if host.is_probable_prime(n, 12):
            out.append(n)
        n -= 2
    if len(out) < count:
        raise ValueError(f"not enough sub-14-bit primes for {count} channels")
    return out


class Rns2Context(NamedTuple):
    """Device constants (pytree) for one modulus N."""

    ic1: jax.Array     # int32 [NI1, k]
    ic2: jax.Array     # int32 [NI2, k]
    f1: jax.Array      # f32 [1, k]: 1/m_i
    f2: jax.Array      # f32 [1, k]: 1/m'_j
    e1g: jax.Array     # int8 [2k, 2*pk]: ext1 lo|gap|hi columns (-> B2)
    e2g: jax.Array     # int8 [2k, 2*pk]: ext2 lo|gap|hi columns (-> B1)

    @property
    def k(self) -> int:
        return self.ic1.shape[-1]

    @property
    def pk(self) -> int:
        """Lane-padded half-width of the merged extension matrices."""
        return self.e1g.shape[-1] // 2


class Rns2Spec:
    """Host-side spec: channel selection, CRT data, folded matrices."""

    def __init__(self, n_modulus: int):
        if n_modulus % 2 == 0:
            raise ValueError("modulus must be odd")
        self.N = n_modulus
        nbits = n_modulus.bit_length()
        # lambda = k * 2^10 covers the digit-inflation alpha1 bound; each
        # channel contributes >= 13 bits.  k rounded to a multiple of 64.
        k = -(-(nbits + 64) // 13)
        k = ((k + 63) // 64) * 64
        while True:
            primes = _primes_descending(2 * k)
            b1, b2 = primes[:k], primes[k:2 * k]
            M = 1
            for p in b1:
                M *= p
            M2 = 1
            for p in b2:
                M2 *= p
            lam = k << 10
            if M >= lam * lam * n_modulus and M2 >= 8 * lam * n_modulus:
                break
            k += 64
        # COX_EPS soundness under the signed-digit lazy mix (see the
        # COX_EPS comment).  Real exceptions, not asserts: these guard
        # against silent numerical corruption (wrong cox alpha -> wrong
        # residues) and must survive ``python -O``.
        drift = (k * 256 * n_modulus) / M2
        f32_err = _cox_sum_error(b2)
        if COX_EPS <= drift + f32_err:
            raise ValueError(
                f"COX_EPS={COX_EPS} too small for k={k}: drift bound "
                f"{drift:.4f} + f32 error {f32_err:.4f}")
        if 0.125 + drift + f32_err + COX_EPS >= 1.0:
            raise ValueError(
                f"cox fraction headroom violated for k={k}: 1/8 + "
                f"{drift:.4f} + {f32_err:.4f} + {COX_EPS} >= 1")
        self.k = k
        self.C = 2 * k
        self.b1, self.b2 = b1, b2
        self.M, self.M2 = M, M2
        self.lam = lam
        self.all_m = b1 + b2
        self.crt_w = [(M // p, pow(M // p, -1, p)) for p in b1]
        self.m2_mod_n = (M * M) % n_modulus
        self.onem_int = M % n_modulus
        # sigma-form scale factors c_j = (M2/m'_j)^-1 mod m'_j (see the
        # ic2 block comment): B2 residues are stored as w*c_j mod m'_j
        self.sigma_c = [pow(M2 // p, -1, p) for p in b2]

    # -- host <-> residues (external format: full-width [B, C], B2 half
    # stored in sigma form) --------------------------------------------------
    def encode(self, values: Sequence[int]) -> np.ndarray:
        k = self.k
        out = np.zeros((len(values), self.C), dtype=np.int32)
        for b, v in enumerate(values):
            for i, m in enumerate(self.b1):
                out[b, i] = v % m
            for j, m in enumerate(self.b2):
                out[b, k + j] = (v % m) * self.sigma_c[j] % m
        return out

    def decode(self, residues: np.ndarray) -> list[int]:
        res = np.asarray(residues, dtype=np.int64)
        out = []
        for b in range(res.shape[0]):
            x = 0
            for i, m in enumerate(self.b1):
                Mi, wi = self.crt_w[i]
                x += ((int(res[b, i]) * wi) % m) * Mi
            out.append((x % self.M) % self.N)
        return out

    # -- device context ------------------------------------------------------
    def build_context(self) -> Rns2Context:
        N, k = self.N, self.k
        b1, b2, M, M2 = self.b1, self.b2, self.M, self.M2

        m1 = np.asarray(b1, dtype=np.int64)
        m2 = np.asarray(b2, dtype=np.int64)
        ic1 = np.zeros((NI1, k), dtype=np.int64)
        ic2 = np.zeros((NI2, k), dtype=np.int64)
        ic1[I1_M] = m1
        ic2[I2_M] = m2
        cs = self.sigma_c
        for j, mj in enumerate(b2):
            minv = pow(M, -1, mj)
            # stored products carry c_j^2; one c_j^-1 = (M2/m'_j) here
            # lands s2_stored * U0S == s2_true * M^-1 * c_j (sigma form)
            ic2[I2_U0S, j] = minv * ((M2 // mj) % mj) % mj
        for i, mi in enumerate(b1):
            ic1[I1_M2M, i] = mi - (M2 % mi)     # ≡ -M2 (mod m_i), in (0, m_i)
            ic1[I1_ENTRY, i] = self.m2_mod_n % mi
            ic1[I1_ONEM, i] = self.onem_int % mi
            ic1[I1_ONE, i] = 1
        for j, mj in enumerate(b2):
            ic2[I2_ENTRY, j] = (self.m2_mod_n % mj) * cs[j] % mj
            ic2[I2_ONEM, j] = (self.onem_int % mj) * cs[j] % mj
            ic2[I2_ONE, j] = cs[j]

        # Each extension is ONE [2k, 2*pk] int8 dot: lo-chunk columns at
        # [0, k), hi-chunk columns at [pk, pk+k), zero gaps up to the
        # 128-aligned offset pk.
        pk = -(-k // 128) * 128

        def merged(T: np.ndarray):
            G = np.zeros((2 * k, 2 * pk), dtype=np.int8)
            G[:, :k] = (T & ((1 << CHUNK) - 1)).astype(np.int8)
            G[:, pk:pk + k] = (T >> CHUNK).astype(np.int8)
            return G

        # ext1 rows (c, i in B1) -> cols j in B2:
        #   A[(c,i), j] = (w_ci * (M/m_i) * N * M^-1 * c_j) mod m'_j,
        #   w_ci = (2^(7c) * k1_i) mod m_i, k1_i = (-N^-1 (M/m_i)^-1) mod m_i
        # (the extra c_j factor lands the dot result in sigma form)
        T1 = np.zeros((2 * k, k), dtype=np.int64)
        for i, mi in enumerate(b1):
            Mdi = M // mi
            k1 = (pow(-N, -1, mi) * pow(Mdi, -1, mi)) % mi
            w0 = k1
            w1 = ((1 << CHUNK) * k1) % mi
            for j, mj in enumerate(b2):
                base = (Mdi % mj) * (N % mj) % mj * pow(M, -1, mj) \
                    % mj * cs[j] % mj
                T1[i, j] = (w0 * base) % mj
                T1[k + i, j] = (w1 * base) % mj

        # ext2 rows (c, j in B2) -> cols i in B1: (2^(7c) * (M2/m'_j)) mod m_i
        T2 = np.zeros((2 * k, k), dtype=np.int64)
        for j, mj in enumerate(b2):
            M2dj = M2 // mj
            for i, mi in enumerate(b1):
                T2[j, i] = M2dj % mi
                T2[k + j, i] = ((1 << CHUNK) * M2dj) % mi

        return Rns2Context(
            ic1=jnp.asarray(ic1.astype(np.int32)),
            ic2=jnp.asarray(ic2.astype(np.int32)),
            f1=jnp.asarray((1.0 / m1.astype(np.float64))
                           .astype(np.float32)[None]),
            f2=jnp.asarray((1.0 / m2.astype(np.float64))
                           .astype(np.float32)[None]),
            e1g=jnp.asarray(merged(T1)), e2g=jnp.asarray(merged(T2)),
        )


# ---------------------------------------------------------------------------
# Montgomery multiply core
# ---------------------------------------------------------------------------

def _red(v, m, inv_m):
    """v mod m for int32 |v| < 2^31 (single float-reciprocal pass).

    Quotient error analysis at the widest callers (v < 1.6e9): the f32
    conversion error is <= 64, inv_m and the product each carry 2^-24
    relative error, so |q_err| <= 128/m + 2*q*2^-24 < 0.1 < 1 for
    m > 2^12.5.  Two conditional fixes absorb the +-1; q*m <= v + m
    stays exact in int32.
    """
    q = jnp.floor(v.astype(jnp.float32) * inv_m).astype(jnp.int32)
    r = v - q * m
    r = jnp.where(r < 0, r + m, r)
    r = jnp.where(r >= m, r - m, r)
    return r


def _red_lazy(v, m, inv_m):
    """Congruence-preserving reduction into (-m, 2m) — skips the two
    conditional fixes of :func:`_red`.

    Same quotient-error analysis as _red (|q_err| < 1 for |v| < 2e9),
    but the +-1 is *absorbed into the output range* instead of being
    fixed up: r = v - q*m lands in (-m, 2m).  Sound wherever only the
    residue class matters (squaring/multiply inputs, channel products
    t1 = s2*U0): |lazy| < 2m < 2^15 keeps every downstream int32
    product below 2^30.  Digits that feed the int8 base-extension
    matmuls or the cox alpha sum (s1, sigma) still need :func:`_red`.
    """
    q = jnp.floor(v.astype(jnp.float32) * inv_m).astype(jnp.int32)
    return v - q * m


def _red_fast(v, m, inv_m):
    """Biased truncating reduction into [0, m + ~740) for v >= 0 — the
    ladder hot path: no floor, no conditional fixes (6 elementwise ops).

    q = trunc(fl(v - B)*inv_m) with the absolute bias B = RED_BIAS_INT.
    The f32 estimate of (v - B)/m carries error delta with
    delta*m <= ~3.5*VMAX*2^-24 < 320 (cast of v, inv_m rounding, product
    rounding — each <= VMAX*2^-24 ~ 100, m-independent in absolute
    units).  Since B > delta*m the estimate never exceeds v/m, so
    q <= q_true; q = q_true - 1 only when frac(v/m)*m < B + delta*m,
    giving r = v - q*m < m + B + 320.  With primes capped at MCAP the
    digits stay < 2^14 - 444, so the two-7-bit-chunk int8 split of
    :func:`_chunks` still holds (hi chunk <= 124).  For v < B the
    product is in (-B/m, 0) and trunc-toward-zero gives q = 0, r = v.
    Digit inflation is harmless everywhere in the ladder: the first
    extension is congruence-only (k1 folded), and the cox alpha of the
    second extension counts inflated digits exactly (sg = sigma +
    delta_j*m'_j raises the alpha sum by exactly sum(delta_j), which
    the alpha*(-M2 mod m_i) correction removes).
    """
    q = ((v - RED_BIAS_INT).astype(jnp.float32) * inv_m).astype(jnp.int32)
    return v - q * m


# Ladder reductions: lazy multiplies reduce digits (s1 / sg, chunked
# into int8) with _red_fast and residue outputs (s2 / w1) with _red_lazy.
# Soundness of _red_fast digits on possibly-negative inputs: outputs
# land in (-m-820, m+820), the 7-bit chunk split stays exact in two's
# complement (hi digit in [-126, 125]), and ext1 is congruence-only.
# The cox alpha of ext2 is where signed digits bite: each per-channel
# deviation delta_j shifts the alpha sum by exactly delta_j (integer
# part — removed exactly by the alpha correction), BUT the underlying
# integer the digit vector represents becomes w0 + t*N with t possibly
# NEGATIVE (|t| <= k*2^8), so the cox fraction can wrap toward
# 1 - |t|*N/M2.  Exactness of floor(sum + COX_EPS) therefore depends on
# the COX_EPS margin — see the COX_EPS comment and the check in
# Rns2Spec.__init__.


def _chunks(v):
    """int32 in (-2^14, 2^14) -> (lo7, hi7) int32 chunks.

    lo in [0, 127], hi = v >> 7 arithmetic: v == lo + 128*hi holds in
    two's complement for negative v too (hi in [-128, 127] for the
    _red_fast digit range), so signed digits stay int8-safe.
    """
    return v & ((1 << CHUNK) - 1), v >> CHUNK


def _dot_i8(lhs_i8, rhs_i8):
    return lax.dot_general(lhs_i8, rhs_i8,
                           (((lhs_i8.ndim - 1,), (0,)), ((), ())),
                           preferred_element_type=jnp.int32)


def _pack_digits(v):
    """int32 digits in (-2^14, 2^14) -> int8 lhs [.., 2k] (lo | hi)."""
    a0, a1 = _chunks(v)
    return jnp.concatenate([a0, a1], axis=-1).astype(jnp.int8)


def _mm_lhs1(ctx: Rns2Context, x, y, lazy: bool):
    """Stage 1: channel products, digit/lazy reds, ext1 lhs pack."""
    x1, x2 = x
    y1, y2 = y
    digit_red = _red_fast if lazy else _red
    # x*y < (1.1m)^2 < 2^28.2: nonneg, digits chunk-safe (< 2^14)
    s1 = digit_red(x1 * y1, ctx.ic1[I1_M], ctx.f1[0])
    s2 = _red_lazy(x2 * y2, ctx.ic2[I2_M], ctx.f2[0])
    return _pack_digits(s1), s2


def _ext_split(P, k: int, pk: int):
    """Split a merged ext dot output into (lo, hi) channel halves."""
    return P[..., :k], P[..., pk:pk + k]


def _mm_ext1(ctx: Rns2Context, lhs1):
    """Stage 2: first base extension (B1 -> B2) as ONE merged int8
    dot [.., 2k] x [2k, 2*pk]; output slices at offsets 0 and pk."""
    k, pk = ctx.k, ctx.pk
    P = _dot_i8(lhs1, ctx.e1g)
    return _ext_split(P, k, pk)


def _mm_lhs2(ctx: Rns2Context, P, s2, lazy: bool):
    """Stage 3: combine ext1 into the sigma-form B2 result, pack the
    ext2 lhs.  Returns (lhs2, sg) — sg IS the B2 output (sigma form),
    so the old separate w2 = red(..) and sg = red(w2*K30) collapse into
    ONE exact reduction (see the sigma-form block comment at ic2)."""
    Plo, Phi = P
    m2 = ctx.ic2[I2_M]
    inv2 = ctx.f2[0]
    digit_red = _red_fast if lazy else _red
    # Plo + (Phi << 7): for k >= 512 the worst case exceeds int32
    # (2k*127*127*129 > 2^31) — reduce the hi dot first on wide specs
    # (4096-bit keys / level-2 at 2048-bit); narrow specs skip the red.
    if P[0].shape[-1] >= 512:
        Phi = digit_red(Phi, m2, inv2)
    v = Plo + (Phi << CHUNK)                # == Q*N*M^-1*c mod m', < 1.4e9
    # t1 = p_j * M^-1 * c_j mod m'_j: s2 < 2^15 (lazy product of
    # sigma-form halves), U0S < 2^14 -> t1 < 2^29; v + t1 < 1.9e9.
    # sg is both the stored B2 residue and the ext2 digit vector; it
    # needs a digit-safe reduction ([0, 2^14), exact in the canonical
    # path — the cox alpha counts any near-canonical digit inflation).
    sg = digit_red(v + s2 * ctx.ic2[I2_U0S], m2, inv2)
    return _pack_digits(sg), sg


def _mm_ext2(ctx: Rns2Context, lhs2):
    """Stage 4: second base extension (B2 -> B1), one merged dot."""
    k, pk = ctx.k, ctx.pk
    V = _dot_i8(lhs2, ctx.e2g)
    return _ext_split(V, k, pk)


def _mm_finish(ctx: Rns2Context, V, sg, lazy: bool):
    """Stage 5: combine ext2 + cox floating alpha -> B1 result."""
    Vlo, Vhi = V
    m1 = ctx.ic1[I1_M]
    inv1 = ctx.f1[0]
    digit_red = _red_fast if lazy else _red
    out_red = _red_lazy if lazy else _red
    if V[0].shape[-1] >= 512:
        Vhi = digit_red(Vhi, m1, inv1)
    v1 = Vlo + (Vhi << CHUNK)                    # == sum sg*(M2/m') mod m_i
    # alpha counts whole multiples of M2 in sum(sg * M2/m'_j), inflated
    # digits included (each +m'_j raises the sum by exactly 1); the
    # correction is ADDED (I1_M2M = -M2 mod m_i > 0) so v1 + alpha*I1_M2M
    # stays in [0, 1.4e9 + 2k*MCAP) < 2^31 and nonneg for _red_fast.
    alpha = jnp.floor(
        jnp.sum(sg.astype(jnp.float32) * ctx.f2[0], axis=-1, keepdims=True)
        + COX_EPS).astype(jnp.int32)
    return out_red(v1 + alpha * ctx.ic1[I1_M2M], m1, inv1)


def rns2_mont_mul_pair(ctx: Rns2Context, x, y, lazy: bool = False):
    """w = x*y*M^-1 mod N on residue pairs ((x1, x2), (y1, y2)).

    Halves are int32 [..., k] residues of values < lambda*N in
    magnitude — canonical [0, m) or, with ``lazy`` chains, SIGNED
    near-canonical: digit-path values in (-m-820, m+820) from
    :func:`_red_fast` and residue outputs in (-m, 2m) from
    :func:`_red_lazy`.  With ``lazy=True`` the outputs are lazy too
    (use inside exponent ladders; finish with one lazy=False multiply
    so the final residues are canonical).  The signed ranges keep every
    int32 product below ~1.9e9 (see _mm_lhs2) and the 7-bit chunk split
    exact in two's complement; cox-alpha exactness under the signed mix
    is guaranteed by the COX_EPS margin (checked in Rns2Spec).
    """
    lhs1, s2 = _mm_lhs1(ctx, x, y, lazy)
    P = _mm_ext1(ctx, lhs1)
    lhs2, sg = _mm_lhs2(ctx, P, s2, lazy)
    V = _mm_ext2(ctx, lhs2)
    w1 = _mm_finish(ctx, V, sg, lazy)
    return w1, sg


def _split(ctx: Rns2Context, x):
    k = ctx.k
    return x[..., :k], x[..., k:]


def rns2_one_plus_mul(ctx: Rns2Context, x, crow):
    """(1 + x*c) mod N as canonical residues, per-channel.

    ``x``: canonical [..., C] residues (B2 half sigma-form, as stored);
    ``crow``: int32 [C] TRUE-form residues of a host constant c (both
    halves unscaled — the sigma factor of the B2 output is inherited
    from x, and the "+1" enters via the stored sigma-form one I2_ONE).
    Ranges: x < 2^14, crow < 2^14 -> products < 2^28, safely inside
    :func:`_red`'s exactness domain.

    This is encryption's G^m shortcut in residue space: gm = 1 + m*n
    (level 1) costs one multiply-add and one exact reduction per
    channel — no limb-domain Toeplitz multiply and no extra
    limb->residue conversion of the product."""
    k = ctx.k
    x1, x2 = x[..., :k], x[..., k:]
    c1, c2 = crow[..., :k], crow[..., k:]
    g1 = _red(x1 * c1 + 1, ctx.ic1[I1_M], ctx.f1[0])
    g2 = _red(x2 * c2 + ctx.ic2[I2_ONE], ctx.ic2[I2_M], ctx.f2[0])
    return jnp.concatenate([g1, g2], axis=-1)


def rns2_mont_mul_values(ctx: Rns2Context, x, y, lazy: bool = False):
    """Full-width [..., C] wrapper around the pair core."""
    w1, w2 = rns2_mont_mul_pair(ctx, _split(ctx, x), _split(ctx, y), lazy)
    return jnp.concatenate([w1, w2], axis=-1)


# ---------------------------------------------------------------------------
# Fixed-window exponentiation
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("window",))
def rns2_pow(ctx: Rns2Context, x, digits, window: int = 4):
    """x^e mod N on residues via lax.scan over 2^window-ary digits.

    ``digits``: int32 [D] shared or [..., D] per-element, MSB-first
    base-2^window.  Input residues of values < lambda*N; output likewise.
    """
    per_element = digits.ndim > 1
    entry = jnp.concatenate([ctx.ic1[I1_ENTRY], ctx.ic2[I2_ENTRY]])
    onem = jnp.concatenate([ctx.ic1[I1_ONEM], ctx.ic2[I2_ONEM]])
    one = jnp.concatenate([ctx.ic1[I1_ONE], ctx.ic2[I2_ONE]])

    xm = rns2_mont_mul_values(ctx, x, jnp.broadcast_to(entry, x.shape),
                              lazy=True)
    one_m = jnp.broadcast_to(onem, x.shape)

    entries = [one_m, xm]
    for _ in range(2, 1 << window):
        entries.append(rns2_mont_mul_values(ctx, entries[-1], xm,
                                            lazy=True))
    tbl = jnp.stack(entries, axis=0)

    def body(acc, d):
        for _ in range(window):
            acc = rns2_mont_mul_values(ctx, acc, acc, lazy=True)
        if per_element:
            t = jnp.take_along_axis(tbl, d[None, ..., None], axis=0)[0]
        else:
            t = jnp.take(tbl, d, axis=0)
        return rns2_mont_mul_values(ctx, acc, t, lazy=True), None

    acc0 = one_m + x * 0
    if per_element:
        acc0 = acc0 + (digits[..., :1] * 0)
    scan_d = jnp.moveaxis(digits, -1, 0) if per_element else digits
    acc, _ = lax.scan(body, acc0, scan_d)
    return rns2_mont_mul_values(ctx, acc, jnp.broadcast_to(one, acc.shape))


# ---------------------------------------------------------------------------
# Shared-exponent sliding-window exponentiation (odd-power table)
# ---------------------------------------------------------------------------

def sliding_window_schedule(e: int, window: int) -> np.ndarray:
    """Recode e >= 1 for a left-to-right sliding-window ladder over the
    odd-power table [x, x^3, x^5, ..., x^(2^window - 1)].

    Returns int32 [1 + S]: out[0] is the odd-table index of the leading
    window; each following entry encodes one ladder step "square, then
    (entry >= 0 ? multiply by table[entry] : nothing)".  Cuts the
    multiplies of a fixed 2^w-ary ladder from bits/w to ~bits/(w+1)
    while the table holds only the odd powers — at window 6 a 2048-bit
    shared exponent runs in ~2373 Montgomery multiplies vs 2574 for the
    fixed window-4 ladder (the r^(n^s) hot path, paillier.go:213-216).
    """
    if e < 1:
        raise ValueError("sliding-window exponent must be >= 1")
    bits = bin(e)[2:]
    nb = len(bits)
    lead = min(window, nb)
    while bits[lead - 1] != "1":        # window must end in a set bit
        lead -= 1
    out = [int(bits[:lead], 2) >> 1]    # odd-table index of leading window
    i = lead
    while i < nb:
        if bits[i] == "0":
            out.append(-1)
            i += 1
            continue
        l = min(window, nb - i)
        while bits[i + l - 1] != "1":
            l -= 1
        out.extend([-1] * (l - 1))
        out.append(int(bits[i:i + l], 2) >> 1)
        i += l
    return np.asarray(out, dtype=np.int32)


@functools.partial(jax.jit, static_argnames=("window",))
def rns2_pow_sliding(ctx: Rns2Context, x, sched, window: int = 6,
                     fin=None):
    """Shared-exponent power via a sliding-window schedule.

    x: [..., C] standard-form residues; sched: int32 [1+S] from
    :func:`sliding_window_schedule` (sentinels: -2 skip, -1 square
    only, d >= 0 square+multiply).  Output matches rns2_pow bit-exactly
    (canonical residues < lambda*N).  ``fin`` (canonical [..., C]
    residues) rides the exit multiply: returns x^e * fin mod N.
    """
    entry = jnp.concatenate([ctx.ic1[I1_ENTRY], ctx.ic2[I2_ENTRY]])
    one = jnp.concatenate([ctx.ic1[I1_ONE], ctx.ic2[I2_ONE]])

    xm = rns2_mont_mul_values(ctx, x, jnp.broadcast_to(entry, x.shape),
                              lazy=True)
    x2 = rns2_mont_mul_values(ctx, xm, xm, lazy=True)
    entries = [xm]
    for _ in range(1, 1 << (window - 1)):
        entries.append(rns2_mont_mul_values(ctx, entries[-1], x2,
                                            lazy=True))
    tbl = jnp.stack(entries, axis=0)

    acc0 = jnp.take(tbl, sched[0], axis=0)

    def body(acc, d):
        def active(a):
            a = rns2_mont_mul_values(ctx, a, a, lazy=True)
            return lax.cond(
                d >= 0,
                lambda b: rns2_mont_mul_values(
                    ctx, b, jnp.take(tbl, jnp.maximum(d, 0), axis=0),
                    lazy=True),
                lambda b: b,
                a)
        return lax.cond(d >= -1, active, lambda a: a, acc), None

    acc, _ = lax.scan(body, acc0, sched[1:])
    last = jnp.broadcast_to(one, acc.shape) if fin is None else fin
    return rns2_mont_mul_values(ctx, acc, last)


# ---------------------------------------------------------------------------
# Fixed-base exponentiation (comb method: zero squarings)
# ---------------------------------------------------------------------------

def build_fixed_base_table(eng: "Rns2Engine", base_int: int, n_digits: int,
                           window: int = 4) -> jnp.ndarray:
    """Residue table T[step*2^w + d] = (base^(d * 2^(w*(D-1-step))) * M)
    mod N in Montgomery form, step 0 = most-significant digit.

    With this table a fixed-base power is D-1 Montgomery multiplies and
    zero squarings — the comb method for Damgard-Jurik "alternative"
    encryption h_s^r (reference: paillier.go:221-238), where the base is
    the public h_s and only the short exponent r varies per element.
    """
    spec = eng.spec
    N, M = spec.N, spec.M
    g = [base_int % N]
    for _ in range(1, n_digits):
        x = g[-1]
        for _ in range(window):
            x = (x * x) % N
        g.append(x)
    vals = []
    for step in range(n_digits):
        gi = g[n_digits - 1 - step]
        cur = M % N                      # d=0 -> 1 in Montgomery form
        gim = gi
        for d in range(1 << window):
            vals.append(cur)
            cur = (cur * gim) % N
    limbs = jnp.asarray(host.ints_to_limbs(vals, eng.converter.L))
    return eng.from_limbs(limbs)


@functools.partial(jax.jit, static_argnames=("window",))
def rns2_pow_fixed_base(ctx: Rns2Context, table, digits,
                        window: int = 4):
    """Fixed-base power via the comb table.

    table: int32 [D*2^w, C] from build_fixed_base_table (Montgomery form);
    digits: int32 [B, D] per-element MSB-first.  Returns standard-form
    residues of base^e (< lambda*N).
    """
    D = digits.shape[-1]
    tbl = table.reshape((D, 1 << window, table.shape[-1]))
    one = jnp.concatenate([ctx.ic1[I1_ONE], ctx.ic2[I2_ONE]])
    dsteps = jnp.moveaxis(digits, -1, 0)            # [D, ...]

    acc0 = jnp.take(tbl[0], dsteps[0], axis=0)      # [..., C]

    def body(acc, xs):
        tstep, d = xs
        return rns2_mont_mul_values(ctx, acc, jnp.take(tstep, d, axis=0),
                                    lazy=True), None

    acc, _ = lax.scan(body, acc0, (tbl[1:], dsteps[1:]))
    return rns2_mont_mul_values(ctx, acc, jnp.broadcast_to(one, acc.shape))


# ---------------------------------------------------------------------------
# Device limb <-> residue conversion (int8 matmuls, exact int32 accum)
# ---------------------------------------------------------------------------

class Rns2Converter:
    """Bidirectional limb-vector <-> RNS-residue conversion on device.

    forward: 7-bit chunks of the 16-bit limbs against the power matrix
    chunk((2^(7c+16l)) mod m_i); int8 dot, exact int32 sums, one
    channel reduction.

    reverse: exact B1 digits eta_i, then an int8 dot against the 7-bit
    column chunks of the limb decompositions of (M/m_i); the alpha*M
    overshoot is fixed with a cox float estimate plus +-M corrections.
    """

    def __init__(self, spec: Rns2Spec, ctx: Rns2Context, n_limbs: int):
        self.spec = spec
        self.ctx = ctx
        self.L = n_limbs
        k, C = spec.k, spec.C
        mask = (1 << CHUNK) - 1

        # forward matrix: rows = 3 chunk blocks x L limbs, cols = (lo|hi) x C;
        # B2 columns carry the sigma-form scale c_j so from_limbs lands
        # directly in the stored representation
        P = np.zeros((n_limbs, C), dtype=np.int64)
        for i, mi in enumerate(spec.all_m):
            scale = spec.sigma_c[i - k] if i >= k else 1
            val, step = scale % mi, pow(2, 16, mi)
            for l in range(n_limbs):
                P[l, i] = val
                val = (val * step) % mi
        rows = []
        for shift in (0, CHUNK, 2 * CHUNK):
            A = (P << shift) % np.asarray(spec.all_m)[None, :]
            rows.append(np.concatenate([A & mask, A >> CHUNK], axis=1))
        self.fwd = jnp.asarray(np.concatenate(rows, axis=0).astype(np.int8))
        self.all_m_dev = jnp.asarray(np.asarray(spec.all_m, dtype=np.int32))
        self.all_inv_dev = jnp.asarray(
            (1.0 / np.asarray(spec.all_m, dtype=np.float64))
            .astype(np.float32))

        # reverse: eta weights and (M/m_i) limb chunk matrix over B1
        ML = max(n_limbs, (spec.M.bit_length() + 15) // 16)
        self.ML = ML
        w = np.zeros(k, np.int64)
        for i, mi in enumerate(spec.b1):
            w[i] = pow(spec.M // mi, -1, mi)
        self.w0 = jnp.asarray(w.astype(np.int32))
        self.w1 = jnp.asarray((((1 << CHUNK) * w)
                               % np.asarray(spec.b1)).astype(np.int32))
        rows = []
        for shift in (0, CHUNK):
            W = np.zeros((k, ML), dtype=np.int64)
            for i, mi in enumerate(spec.b1):
                W[i] = host.int_to_limbs((spec.M // mi) << shift, ML
                                         ).astype(np.int64)
            rows.append(np.concatenate(
                [W & mask, (W >> CHUNK) & mask, W >> (2 * CHUNK)], axis=1))
        self.rev = jnp.asarray(np.concatenate(rows, axis=0).astype(np.int8))
        self.inv_b1 = jnp.asarray(
            (1.0 / np.asarray(spec.b1, dtype=np.float64)).astype(np.float32))
        self.M_limbs = jnp.asarray(host.int_to_limbs(spec.M, ML))

    def from_limbs(self, x: jnp.ndarray) -> jnp.ndarray:
        """uint32 limbs [..., L] -> standard residues int32 [..., C]."""
        return _rns2_from_limbs(self.fwd, self.all_m_dev, self.all_inv_dev, x)

    def to_limbs(self, x: jnp.ndarray) -> jnp.ndarray:
        """residues [..., C] -> uint32 limbs [..., ML] of the exact
        value (< M)."""
        return _rns2_to_limbs(self.ctx, self.rev, self.w0, self.w1,
                              self.inv_b1, self.M_limbs, x)


@jax.jit
def _rns2_from_limbs(fwd, all_m, all_inv, x):
    mask = (1 << CHUNK) - 1
    xi = x.astype(jnp.int32)
    lhs = jnp.concatenate([xi & mask, (xi >> CHUNK) & mask,
                           xi >> (2 * CHUNK)], axis=-1).astype(jnp.int8)
    P = lax.dot_general(lhs, fwd, (((lhs.ndim - 1,), (0,)), ((), ())),
                        preferred_element_type=jnp.int32)
    C = P.shape[-1] // 2
    vhi = _red(P[..., C:], all_m, all_inv)
    return _red(P[..., :C] + (vhi << CHUNK), all_m, all_inv)


@jax.jit
def _rns2_to_limbs(ctx: Rns2Context, rev, w0, w1, inv_b1, M_limbs, x):
    from . import vpu
    k = ctx.k
    m1 = ctx.ic1[I1_M]
    inv1 = ctx.f1[0]
    x1 = x[..., :k]
    c0, c1 = _chunks(x1)
    eta = _red(c0 * w0 + c1 * w1, m1, inv1)
    e0, e1 = _chunks(eta)
    lhs = jnp.concatenate([e0, e1], axis=-1).astype(jnp.int8)
    P = lax.dot_general(lhs, rev, (((lhs.ndim - 1,), (0,)), ((), ())),
                        preferred_element_type=jnp.int32)
    ML = P.shape[-1] // 3
    # combine the three chunk column blocks without overflowing the < 2^31
    # bound vpu.normalize needs: route the high bits of the shifted blocks
    # into the next limb (weight 2^16) instead of shifting in place.
    P0 = P[..., :ML].astype(jnp.uint32)
    P1 = P[..., ML:2 * ML].astype(jnp.uint32)
    P2 = P[..., 2 * ML:].astype(jnp.uint32)
    lo = P0 + ((P1 & 0x1FF) << CHUNK) + ((P2 & 0x3) << (2 * CHUNK))
    hi = (P1 >> 9) + (P2 >> 2)            # units of 2^16: next limb up
    hi_shift = jnp.concatenate(
        [jnp.zeros_like(hi[..., :1]), hi[..., :-1]], axis=-1)
    total = vpu.normalize(lo + hi_shift)
    # alpha may be off by one either way (the f32 sum is reduced in an
    # order XLA picks): one too large makes total - aM borrow and the
    # +M fix-up below restores it; one too small leaves cand in [M, 2M)
    # and the final cond_sub removes it.
    frac = jnp.sum(eta.astype(jnp.float32) * inv_b1, axis=-1)
    alpha = jnp.floor(frac + 0.5 ** 12).astype(jnp.uint32)
    aM = vpu.mul(alpha[..., None], M_limbs, ML)
    cand, borrow = vpu.sub(total, aM)
    fixed_up, _ = vpu.add(cand, jnp.broadcast_to(M_limbs, cand.shape))
    cand = jnp.where(borrow[..., None] != 0, fixed_up, cand)
    return vpu.cond_sub(cand, jnp.broadcast_to(M_limbs, cand.shape))


# ---------------------------------------------------------------------------
# Engine facade
# ---------------------------------------------------------------------------

class Rns2Engine:
    """User-facing v2 engine for one modulus N."""

    def __init__(self, n_modulus: int, n_limbs: int | None = None):
        self.spec = Rns2Spec(n_modulus)
        self.ctx = self.spec.build_context()
        L = n_limbs or host.limbs_for_bits(n_modulus.bit_length())
        self.converter = Rns2Converter(self.spec, self.ctx, L)
        self.m2_rns = jnp.concatenate([self.ctx.ic1[I1_ENTRY],
                                       self.ctx.ic2[I2_ENTRY]])
        self._sched_cache: dict = {}
        from .limbmm import BarrettPlan
        self.barrett = BarrettPlan.build(n_modulus)

    def encode(self, values) -> jnp.ndarray:
        return jnp.asarray(self.spec.encode(list(values)))

    def decode(self, residues) -> list:
        return self.spec.decode(np.asarray(jax.device_get(residues)))

    def from_limbs(self, x):
        return self.converter.from_limbs(x)

    def to_limbs(self, x):
        return self.converter.to_limbs(x)

    def to_limbs_mod(self, x):
        """Residues of a value < 2^28 * N -> exact limbs of (value mod N).

        Covers every engine output (invariant: values < lambda*N); one
        int8 matmul (to_limbs) plus an O(L) small-quotient Barrett — no
        O(L^2) limb Montgomery reduction.
        """
        from .limbmm import barrett_small
        return barrett_small(self.to_limbs(x), self.barrett)

    def mont_mul(self, x, y):
        return rns2_mont_mul_values(self.ctx, x, y)

    def mul(self, x, y):
        """Plain modular product (fix the M^-1 with the entry factor)."""
        t = rns2_mont_mul_values(self.ctx, x, y)
        return rns2_mont_mul_values(
            self.ctx, t, jnp.broadcast_to(self.m2_rns, t.shape))

    def pow(self, x, digits, window: int = 4):
        return rns2_pow(self.ctx, x, digits, window)

    def pow_shared(self, x, e: int, window: int | None = None, fin=None):
        """x^e for a host-known shared exponent via the sliding-window
        odd-power ladder — ~8% fewer Montgomery multiplies than the
        fixed window-4 ladder on 2048-bit exponents (the r^(n^s) /
        c^lambda hot paths).  Window defaults to Config.sliding_window.

        ``fin`` (canonical residues) is fused into the ladder's exit
        multiply: returns x^e * fin mod N at zero extra multiplies."""
        from ..config import get_config
        if window is None:
            window = get_config().sliding_window
        if e == 0:
            one = jnp.concatenate([self.ctx.ic1[I1_ONE],
                                   self.ctx.ic2[I2_ONE]])
            out = jnp.broadcast_to(one, x.shape)
            return out if fin is None else self.mul(out, fin)
        key = (e, window)
        sched = self._sched_cache.get(key)
        if sched is None:
            # cache the HOST array: jnp constants created inside a jit
            # trace are tracers and must not outlive the trace
            sched = sliding_window_schedule(e, window)
            self._sched_cache[key] = sched
        return rns2_pow_sliding(self.ctx, x, jnp.asarray(sched), window,
                                fin=fin)
