"""Batched homomorphic operations (reference: operations.go:11-140).

add       : elementwise ciphertext product mod n^(s+1)
sub       : product with modular inverse of the subtrahend
const_mult: ciphertext^k
randomize : add a fresh encryption of zero
aggregate : modular product reduction over an axis (the 1M-ciphertext
            aggregation path, BASELINE config #3) — a log-depth tree of
            Montgomery products with a single R-power fixup.
nested_*  : ops on (level-2, level-1) ciphertext pairs
extract_randomness : recover r from a ciphertext with the secret key

Modular inversion (sub / nested_sub) uses an extended-gcd on host per
element; ciphertext counts there are control-plane sized.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..bigint import host, vpu
from ..bigint import montgomery as mont
from ..ops import random as prand
from .encrypt import Encryptor, gm_binomial
from .keys import (LEVEL_ONE, LEVEL_TWO, MIXED, Ciphertext, DeviceKey,
                   PublicKey, SecretKey, decode_batch, encode_batch)


def _ctx(pk: PublicKey, level: int):
    return pk.device().ctx_for_level(level)


def add(pk: PublicKey, *cts: Ciphertext) -> Ciphertext:
    """Homomorphic addition: elementwise product mod n^(s+1)
    (reference: operations.go:11-29)."""
    level = cts[0].level
    ctx = _ctx(pk, level)
    acc = cts[0].c
    for ct in cts[1:]:
        if ct.level != level:
            raise ValueError("cannot add ciphertexts at different levels")
        acc = mont.modmul(ctx, acc, ct.c)
    return Ciphertext(c=acc, level=level, method=MIXED)


def sub(pk: PublicKey, *cts: Ciphertext) -> Ciphertext:
    """Homomorphic subtraction from the first argument
    (reference: operations.go:32-55).  Inverses are computed host-side."""
    level = cts[0].level
    ctx = _ctx(pk, level)
    mod = pk.modulus_for_level(level)
    acc = cts[0].c
    for ct in cts[1:]:
        inv = host.modinv_batch(decode_batch(ct.c), mod)
        inv_l = encode_batch(inv, ct.c.shape[-1]).reshape(ct.c.shape)
        acc = mont.modmul(ctx, acc, inv_l)
    return Ciphertext(c=acc, level=level, method=MIXED)


def const_mult(pk: PublicKey, ct: Ciphertext, k) -> Ciphertext:
    """ct^k mod n^(s+1) (reference: operations.go:58-64).

    ``k`` may be a single int (shared) or a sequence of per-element ints.
    """
    dk = pk.device()
    level = ct.level
    window = 4
    if isinstance(k, (int, np.integer)):
        c = dk.pow_int(level, ct.c, int(k), window)
    else:
        bits = max(int(ki).bit_length() for ki in k) or 1
        nd = mont.n_digits_for_bits(bits, window)
        digits = np.stack([mont.exp_digits(int(ki), window, nd) for ki in k])
        digits = jnp.asarray(digits.reshape(ct.c.shape[:-1] + (nd,)))
        c = dk.pow(level, ct.c, digits, window)
    return Ciphertext(c=c, level=level, method=ct.method)


def randomize(pk: PublicKey, ct: Ciphertext, rng=None) -> Ciphertext:
    """Re-randomize by adding Enc(0) (reference: operations.go:67-69)."""
    enc = Encryptor(pk, ct.level, rng=rng)
    zeros = enc.encrypt([0] * int(np.prod(ct.batch_shape or (1,))))
    z = Ciphertext(c=zeros.c.reshape(ct.c.shape), level=ct.level)
    return add(pk, ct, z)


# ---------------------------------------------------------------------------
# Aggregation: modular product over an axis (1M-ciphertext adds)
# ---------------------------------------------------------------------------

def aggregate_kernel(ctx: mont.MontCtx, c: jnp.ndarray,
                     r_fix: jnp.ndarray) -> jnp.ndarray:
    """Product of c[m, ..., L] over axis 0 mod n, via a log-depth tree of
    Montgomery multiplies.  ``r_fix`` = R^(m) mod n corrects the R^-(m-1)
    accumulated by the m-1 tree multiplies (one extra mont_mul).
    """
    x = c
    while x.shape[0] > 1:
        m = x.shape[0]
        if m % 2:
            pad_one = jnp.broadcast_to(ctx.one_m * 0, x[:1].shape
                                       ).at[..., 0].set(1)
            x = jnp.concatenate([x, pad_one], axis=0)
            m += 1
        x = mont.mont_mul(ctx, x[0::2], x[1::2])
    return mont.mont_mul(ctx, x[0], jnp.broadcast_to(r_fix, x[0].shape))


def aggregate(pk: PublicKey, ct: Ciphertext, axis: int = 0,
              engine: str = "auto") -> Ciphertext:
    """Homomorphic sum of a whole batch: prod_i c_i mod n^(s+1).

    On accelerators with large keys the product tree runs in the RNS
    engine: each level is pointwise channel products + two int8 base
    extensions instead of O(L^2) limb scans.
    """
    dk = pk.device()
    c = jnp.moveaxis(ct.c, axis, 0)
    m = c.shape[0]
    mod = pk.modulus_for_level(ct.level)
    if engine == "auto":
        engine = "rns" if dk.use_rns() else "limb"

    # The whole product tree runs inside ONE jit (cached per shape):
    # an eager per-level formulation pays one dispatch per tree level.
    key = ("agg", engine, ct.level, m, c.shape[-1])
    fn = dk.jit_cache.get(key)
    if fn is None:
        if engine == "rns":
            eng = dk.rns(ct.level)
            level = ct.level
            t_pow = _tree_r_power(m)
            fix_np = eng.spec.encode([pow(eng.spec.M, t_pow + 1, mod)])
            one_np = eng.spec.encode([1])

            def agg_fn(c):
                x = eng.from_limbs(c)
                while x.shape[0] > 1:
                    if x.shape[0] % 2:
                        x = jnp.concatenate([x, jnp.asarray(one_np)],
                                            axis=0)
                    x = eng.mont_mul(x[0::2], x[1::2])
                # each tree multiply divides by M; restore with one mult
                out_rns = eng.mont_mul(x[0], jnp.asarray(fix_np)[0])
                return dk._widen(eng.to_limbs_mod(out_rns[None]), level)[0]
        else:
            ctx = dk.ctx_for_level(ct.level)
            Ltot = c.shape[-1]
            R = 1 << (host.LIMB_BITS * Ltot)
            # every tree mont_mul contributes an R^{-1}; padding elements
            # are the integer 1, so they contribute none of their own.
            r_pow = _tree_r_power(m)
            r_fix = pow(R, r_pow + 1, mod)  # +1 for the final fixup
            rf = encode_batch([r_fix], Ltot)[0]

            def agg_fn(c):
                return aggregate_kernel(ctx, c, rf)

        fn = jax.jit(agg_fn)
        dk.jit_cache[key] = fn
    return Ciphertext(c=fn(c), level=ct.level, method=MIXED)


def aggregate_streaming(pk: PublicKey, chunks: Iterable[Ciphertext],
                        engine: str = "auto") -> Ciphertext:
    """Homomorphic sum over an unbounded stream of ciphertext batches.

    Each chunk is reduced on device with :func:`aggregate` and the
    running partial is folded in with one modular multiply, so device
    memory stays bounded by one chunk regardless of the stream length
    (config #3: 1M-ciphertext aggregation through the library API, not
    a bench-side loop).  Chunks may have different batch sizes.
    """
    partial = None
    level = None
    for ct in chunks:
        if level is None:
            level = ct.level
        elif ct.level != level:
            raise ValueError("cannot aggregate ciphertexts at "
                             "different levels")
        p = aggregate(pk, ct, axis=0, engine=engine)
        if partial is None:
            partial = p
        else:
            ctx = _ctx(pk, level)
            partial = Ciphertext(
                c=mont.modmul(ctx, partial.c, p.c), level=level,
                method=MIXED)
    if partial is None:
        raise ValueError("aggregate_streaming needs at least one chunk")
    return partial


def _tree_r_power(m: int) -> int:
    """Total R^{-1} deficit of the product tree for m elements (exact)."""
    # every mont_mul halving step multiplies pairs; track the exponent of
    # R^{-1} attached to the surviving lane containing the true product.
    # All m real elements start with deficit 0; padded 1s have deficit 0 too
    # (they are the integer 1).  Each level: new_deficit = d_a + d_b + 1.
    deficits = [0] * m
    while len(deficits) > 1:
        if len(deficits) % 2:
            deficits.append(0)
        deficits = [deficits[i] + deficits[i + 1] + 1
                    for i in range(0, len(deficits), 2)]
    return deficits[0]


# ---------------------------------------------------------------------------
# Nested ops (level-2 x level-1)
# ---------------------------------------------------------------------------

def nested_add(pk: PublicKey, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
    """ct1^(ct2.c) mod n^3 (reference: operations.go:121-127)."""
    if ct1.level != LEVEL_TWO or ct2.level != LEVEL_ONE:
        raise ValueError("nested_add needs (level-2, level-1) ciphertexts")
    dk = pk.device()
    window = 4
    digits = mont.limbs_to_digits(ct2.c, 4)
    c = dk.pow(LEVEL_TWO, ct1.c, digits, 4)
    return Ciphertext(c=c, level=LEVEL_TWO, method=ct1.method)


def nested_sub(pk: PublicKey, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
    """ct1^(ct2.c^{-1} mod n^2) (reference: operations.go:130-140)."""
    if ct1.level != LEVEL_TWO or ct2.level != LEVEL_ONE:
        raise ValueError("nested_sub needs (level-2, level-1) ciphertexts")
    mod = pk.n2
    inv = host.modinv_batch(decode_batch(ct2.c), mod)
    inv_l = encode_batch(inv, ct2.c.shape[-1]).reshape(ct2.c.shape)
    return nested_add(pk, ct1, Ciphertext(c=inv_l, level=LEVEL_ONE))


def nested_randomize(pk: PublicKey, ct: Ciphertext, rng=None,
                     rs: Sequence[tuple[int, int]] | None = None):
    """ct' = ct^(a^n mod n^2) * b^(n^2) mod n^3, returning (ct', a, b)
    (reference: operations.go:96-118)."""
    if ct.level != LEVEL_TWO:
        raise ValueError("can only nested-randomize level-2 ciphertexts")
    rng = rng or prand.make_rng()
    count = int(np.prod(ct.batch_shape or (1,)))
    if rs is None:
        rs = [(prand.random_unit(pk.n, rng), prand.random_unit(pk.n, rng))
              for _ in range(count)]
    a_list = [x[0] for x in rs]
    b_list = [x[1] for x in rs]
    dk = pk.device()
    window = 4
    a = encode_batch(a_list, 2 * dk.L).reshape(ct.c.shape[:-1] + (2 * dk.L,))
    b = encode_batch(b_list, 3 * dk.L).reshape(ct.c.shape[:-1] + (3 * dk.L,))
    an = dk.pow_int(1, a, pk.n, window)                     # a^n mod n^2
    bn2 = dk.pow_int(2, b, pk.n2, window)                    # b^(n^2) mod n^3
    digits = mont.limbs_to_digits(an, 4)
    ctan = dk.pow(2, ct.c, digits, 4)
    c = mont.modmul(dk.ctx_n3, ctan, bn2)
    out = Ciphertext(c=c, level=LEVEL_TWO, method="regular")
    return out, a_list, b_list


def extract_randomness(sk: SecretKey, ct: Ciphertext, window: int = 4
                       ) -> list[int]:
    """Recover the encryption randomness r with the secret key
    (reference: operations.go:75-91 "ExtractRandonness" [sic]).

    z = c * G^{-m} mod n^(s+1) encrypts 0, so z = r^(n^s); then
    r = z^((n^s)^{-1} mod lambda) mod n.
    """
    from .decrypt import Decryptor
    dk = sk.device()
    s = 1 if ct.level == LEVEL_ONE else 2
    ns = sk.n ** s
    ctx = dk.ctx_for_level(ct.level)
    dec = Decryptor(sk, ct.level, window=window)
    v = dec.decrypt_array(ct)                      # plaintext m [..., sL]
    # G^{-m} = G^{(n^s - m) mod n^s} via the binomial shortcut
    ns_l = encode_batch([ns], s * dk.L)[0]
    negv, borrow = vpu.sub(jnp.broadcast_to(ns_l, v.shape), v)
    # m == 0 -> n^s - 0 == n^s == 0 mod n^s: G^0 = 1; handle via masking
    negv = jnp.where(vpu.is_zero(v)[..., None], jnp.zeros_like(negv), negv)
    ginv = gm_binomial(dk, negv, ct.level)
    z = mont.modmul(ctx, ct.c, ginv)
    ns_inv = pow(ns, -1, sk.lam)                   # shared secret exponent
    nd = mont.n_digits_for_bits(ns_inv.bit_length() or 1, window)
    digits = jnp.asarray(mont.exp_digits(ns_inv, window, nd))
    # result lives mod n: reduce z mod n first
    z_mod_n = _reduce_to_n(dk, z)
    r = mont.mont_pow_digits(dk.ctx_n, z_mod_n, digits, window)
    return decode_batch(r)


def _reduce_to_n(dk: DeviceKey, z: jnp.ndarray) -> jnp.ndarray:
    """Reduce a (up to 4L)-limb value < n^3 mod n: first mod n^2, then mod n."""
    L = dk.L
    x = z
    if x.shape[-1] > 2 * L:
        x = mont.mod_wide(dk.ctx_n2, _pad_to(x, 4 * L))   # < n^2
    return mont.mod_wide(dk.ctx_n, _pad_to(x, 2 * L))


def _pad_to(x: jnp.ndarray, width: int) -> jnp.ndarray:
    pad = width - x.shape[-1]
    if pad < 0:
        raise ValueError("cannot truncate")
    if pad == 0:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
