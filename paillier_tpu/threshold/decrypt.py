"""Threshold (share) decryption and combining (reference:
thresholdkey.go:63-221).

Per-server partial decryption c_i = c^(2*delta*s_i) mod n^2 is a batched
device modexp with a shared exponent.  Combining is the reference's
Lagrange-weighted product c' = prod_i c_i^(2*lambda_i) mod n^2 — here the
per-share powers run batched on device, positive- and negative-exponent
contributions accumulate into separate products, and a single batched
inverse merges them (one inverse per ciphertext instead of one per
share).  m = (4 delta^2)^{-1} * L(c') mod n.

Integer-division semantics in the Lagrange weights follow Go's Euclidean
big.Int.Div exactly (go_div) so weights agree bit-for-bit with the
reference (thresholdkey.go:91-107).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..bigint import host, vpu
from ..bigint import montgomery as mont
from ..core.keys import Ciphertext, decode_batch, encode_batch
from .keys import PartialDecryption, ThresholdPublicKey, ThresholdSecretKey


def go_div(a: int, b: int) -> int:
    """Go big.Int.Div: Euclidean division (remainder in [0, |b|))."""
    q, r = divmod(a, b)
    if r < 0:
        q += 1
    return q


def L_int(u: int, n: int) -> int:
    """Host L function L(u, n) = (u - 1) / n with Go Div semantics
    (paillier.go:437-440; KAT L(21, 3) = 6, paillier_test.go:20-27)."""
    return go_div(u - 1, n)


@dataclass
class PartialDecryptionBatch:
    """A batch of partial decryptions from one server."""

    id: int
    c: jax.Array      # uint32[..., 2L]


# ---------------------------------------------------------------------------
# Partial decryption
# ---------------------------------------------------------------------------

def partial_decrypt(tsk: ThresholdSecretKey, ct: Ciphertext,
                    window: int = 4) -> PartialDecryptionBatch:
    """c_i = c^(2*delta*share) mod n^2 (thresholdkey.go:192-201), batched
    over the ciphertexts."""
    dk = tsk.device()
    exp = 2 * tsk.delta * tsk.share
    out = dk.pow_int(1, ct.c, exp, window)
    return PartialDecryptionBatch(id=tsk.id, c=out)


def partial_decrypt_all(tsks: Sequence[ThresholdSecretKey], ct: Ciphertext,
                        window: int = 4) -> List[PartialDecryptionBatch]:
    """All t servers' partial decryptions in ONE device dispatch.

    The reference runs one full-width modexp per server
    (thresholdkey.go:192-201); here the t shared-exponent sliding
    ladders run back-to-back inside a single jit with the ciphertext's
    limb->residue conversion computed ONCE and shared — no per-server
    dispatches, conversions or output syncs.  Returns one PartialDecryptionBatch per server,
    bit-identical to t partial_decrypt calls."""
    dk = tsks[0].device()
    exps = tuple(2 * tsk.delta * tsk.share for tsk in tsks)
    key = ("thresh_partial_all", exps, window, ct.c.shape[-1])
    if key not in dk.jit_cache:
        if dk.use_rns():
            eng = dk.rns(1)
            if hasattr(eng, "pow_shared"):
                def _fn(c):
                    x = eng.from_limbs(c)
                    return jnp.stack([
                        dk._widen(eng.to_limbs_mod(eng.pow_shared(x, e)), 1)
                        for e in exps])
            else:
                def _fn(c):
                    return jnp.stack([dk.pow_int(1, c, e, window)
                                      for e in exps])
        else:
            def _fn(c):
                return jnp.stack([dk.pow_int(1, c, e, window)
                                  for e in exps])
        dk.jit_cache[key] = jax.jit(_fn)
    rows = dk.jit_cache[key](ct.c)
    return [PartialDecryptionBatch(id=tsk.id, c=rows[i])
            for i, tsk in enumerate(tsks)]


def partial_decrypt_int(tsk: ThresholdSecretKey, c: int) -> PartialDecryption:
    """Single-value host variant (parity with thresholdkey_test.go:58-74)."""
    exp = 2 * tsk.delta * tsk.share
    return PartialDecryption(id=tsk.id, decryption=pow(c, exp, tsk.n2))


# ---------------------------------------------------------------------------
# Combining
# ---------------------------------------------------------------------------

def verify_partial_decryptions(tpk: ThresholdPublicKey,
                               shares: Sequence) -> None:
    """Threshold/duplicate validation (thresholdkey.go:77-89)."""
    if len(shares) < tpk.t:
        raise ValueError("Threshold not meet")
    ids = {s.id for s in shares}
    if len(ids) != len(shares):
        raise ValueError("two shares has been created by the same server")


def compute_lambda(tpk: ThresholdPublicKey, share_id: int,
                   ids: Sequence[int]) -> int:
    """Lagrange weight, replicating the reference's incremental
    integer-division order exactly (thresholdkey.go:91-107)."""
    lam = tpk.delta
    for other in ids:
        if other != share_id:
            lam = go_div(lam * (-other), share_id - other)
    return lam


def _tree_modmul(ctx, x: jnp.ndarray) -> jnp.ndarray:
    """Log-depth modular product over axis 0 of [S, ..., L]."""
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            pad_one = jnp.zeros_like(x[:1]).at[..., 0].set(1)
            x = jnp.concatenate([x, pad_one], axis=0)
        x = mont.modmul(ctx, x[0::2], x[1::2])
    return x[0]


def lagrange_powers(tpk: ThresholdPublicKey, stacked_c: jnp.ndarray,
                    exps: Sequence[int], window: int = 4) -> jnp.ndarray:
    """c_s^(exps[s]) mod n^2 for every server row of [S, B, 2L] in ONE
    batched per-element ladder (the reference runs one modexp per share,
    thresholdkey.go:119-124)."""
    dk = tpk.device()
    L = dk.L
    S, B = stacked_c.shape[:2]
    w = window if host.LIMB_BITS % window == 0 else 4
    ebits = max(max(e.bit_length() for e in exps), 1)
    ew = -(-ebits // host.LIMB_BITS)
    e_digits = mont.limbs_to_digits(
        encode_batch(list(exps), ew), w)              # [S, D]
    dig = jnp.broadcast_to(e_digits[:, None, :],
                           (S, B, e_digits.shape[-1]))
    powed = dk.pow(1, stacked_c.reshape(S * B, 2 * L),
                   dig.reshape(S * B, -1), w)
    return powed.reshape(S, B, 2 * L)


def _combine_products(dk, powed: jnp.ndarray, sel) -> tuple:
    """Masked positive/negative share products over axis 0 of
    [S, B, 2L] -> two [B, 2L] limb tensors.

    On the RNS engine the S-way products run as residue multiplies
    (one int8-matmul Montgomery multiply per tree node) instead of limb
    Montgomery multiplies, whose O(L^2) limb steps dominate the tree."""
    L = dk.L
    if dk.use_rns():
        from ..bigint.rns2 import Rns2Engine
        eng = dk.rns(1)
        if isinstance(eng, Rns2Engine):
            key = ("combine_tree", powed.shape, bool(sel is not None))
            if key not in dk.jit_cache:
                def _fn(powed, sel):
                    from ..bigint.rns2 import I1_ONE, I2_ONE
                    x = eng.from_limbs(powed)               # [S, B, C]
                    one = jnp.concatenate([eng.ctx.ic1[I1_ONE],
                                           eng.ctx.ic2[I2_ONE]])
                    one = jnp.broadcast_to(one, x.shape)
                    pos = jnp.where(sel, x, one)
                    neg = jnp.where(sel, one, x)

                    def tree(v):
                        while v.shape[0] > 1:
                            if v.shape[0] % 2:
                                v = jnp.concatenate(
                                    [v, one[:1]], axis=0)
                            v = eng.mul(v[0::2], v[1::2])
                        return v[0]

                    to_l = lambda v: dk._widen(eng.to_limbs_mod(v), 1)
                    return to_l(tree(pos)), to_l(tree(neg))
                dk.jit_cache[key] = jax.jit(_fn)
            return dk.jit_cache[key](powed, sel)
    ctx = dk.ctx_n2
    one_r = jnp.zeros_like(powed).at[..., 0].set(1)
    pos = _tree_modmul(ctx, jnp.where(sel, powed, one_r))
    neg = _tree_modmul(ctx, jnp.where(sel, one_r, powed))
    return pos, neg


def combine(tpk: ThresholdPublicKey,
            shares: Sequence[PartialDecryptionBatch],
            window: int = 4) -> List[int]:
    """Merge partial decryptions into plaintexts
    (thresholdkey.go:149-161), batched over ciphertexts AND shares: the
    t Lagrange-weighted powers run as one stacked device ladder, then
    masked products (residue-space on the RNS engine) give the
    positive/negative parts."""
    verify_partial_decryptions(tpk, shares)
    dk = tpk.device()
    ctx = dk.ctx_n2
    L = dk.L
    ids = [s.id for s in shares]

    batch_shape = shares[0].c.shape[:-1]
    one = jnp.zeros(batch_shape + (2 * L,), jnp.uint32).at[..., 0].set(1)
    lam2s = [2 * compute_lambda(tpk, s.id, ids) for s in shares]
    use = [(s, l2) for s, l2 in zip(shares, lam2s) if l2 != 0]
    if use:
        stacked = jnp.stack([s.c.reshape((-1, 2 * L)) for s, _ in use])
        powed = lagrange_powers(tpk, stacked,
                                [abs(l2) for _, l2 in use], window)
        sel = jnp.asarray(np.asarray(
            [l2 > 0 for _, l2 in use]))[:, None, None]
        pos, neg = _combine_products(dk, powed, sel)
        pos = pos.reshape(batch_shape + (2 * L,))
        neg = neg.reshape(batch_shape + (2 * L,))
    else:
        pos = neg = one

    # c' = pos * neg^{-1} mod n^2 — one batched inverse via host xgcd
    # (public operation: no secret exponent exists to Fermat-invert on
    # device, so the inverse batch round-trips the host by necessity)
    neg_vals = decode_batch(neg.reshape((-1, 2 * L)))
    inv_vals = host.modinv_batch(neg_vals, tpk.n2)
    neg_inv = encode_batch(inv_vals, 2 * L).reshape(neg.shape)

    # cprime, L-function and the final constant multiply in one jit
    # (cprime rides the RNS engine when available)
    key = ("combine_tail", pos.shape)
    if key not in dk.jit_cache:
        from ..bigint.rns2 import Rns2Engine
        eng = dk.rns(1) if dk.use_rns() else None
        use_eng = isinstance(eng, Rns2Engine)

        def _tail(pos, neg_inv):
            if use_eng:
                cprime = dk._widen(eng.to_limbs_mod(
                    eng.mul(eng.from_limbs(pos),
                            eng.from_limbs(neg_inv))), 1)
            else:
                cprime = mont.modmul(ctx, pos, neg_inv)
            onew = jnp.zeros_like(cprime).at[..., 0].set(1)
            um1, _ = vpu.sub(cprime, onew)
            lval = mont.exact_div(um1, dk.n_hensel_2L, 2 * L)[..., :L]
            const = jnp.asarray(host.int_to_limbs(
                tpk.combine_shares_constant, L))
            return mont.modmul(dk.ctx_n, lval,
                               jnp.broadcast_to(const, lval.shape))
        dk.jit_cache[key] = jax.jit(_tail)
    m = dk.jit_cache[key](pos, neg_inv)
    return decode_batch(m.reshape((-1, L)))


def combine_ints(tpk: ThresholdPublicKey,
                 shares: Sequence[PartialDecryption]) -> int:
    """Host-int combining for single values (parity with
    thresholdkey_test.go:267-281)."""
    verify_partial_decryptions(tpk, shares)
    ids = [s.id for s in shares]
    cprime = 1
    for s in shares:
        lam2 = 2 * compute_lambda(tpk, s.id, ids)
        if lam2 >= 0:
            cprime = (cprime * pow(s.decryption, lam2, tpk.n2)) % tpk.n2
        else:
            cprime = (cprime * host.modinv(
                pow(s.decryption, -lam2, tpk.n2), tpk.n2)) % tpk.n2
    return (tpk.combine_shares_constant * L_int(cprime, tpk.n)) % tpk.n
