"""Share-decryption zero-knowledge proofs (reference:
thresholdkey.go:225-326).

Fiat-Shamir: a = (c^4)^r, b = V^r mod n^2, e = SHA256(a||b||c^4||c_i^2),
z = r + e*delta*s_i.  Note the hash covers the UNREDUCED integers c^4 and
c_i^2 (the reference exponentiates with a nil modulus at
thresholdkey.go:241,248) — we compute those full-width products on device
and hash their minimal big-endian bytes for bit parity.

Batching (the reference loops per ciphertext): the whole
pipeline stays on device — the two modexps are batched ladders, the
unreduced c^4/c_i^2 are full-width limb products, and the
Fiat-Shamir hashes run through the vectorized device SHA-256
(ops/sha256.py), exactly like zk/ddleq.py does for DDLEQ challenges.
The only host arithmetic is the per-element response z = r + e*delta*s
(one big-int multiply-add each) and one batched native inverse in the
verifier.  ``verify_proofs`` is the batched device verifier;
``verify_proof`` is the host control-plane single-proof variant kept
for parity tests and serialization checks.
"""

from __future__ import annotations

from typing import List, Sequence

import jax.numpy as jnp
import numpy as np

from ..bigint import host, vpu
from ..bigint import montgomery as mont
from ..core.keys import Ciphertext, decode_batch, encode_batch
from ..ops import random as prand
from ..ops.oracle import zkp_hash
from ..ops.sha256 import concat_be, digest_to_ints, limbs_to_be_bytes, \
    sha256_bytes
from .decrypt import PartialDecryptionBatch, partial_decrypt
from .keys import (PartialDecryption, PartialDecryptionZKP,
                   ThresholdPublicKey, ThresholdSecretKey)


def _zkp_challenges(a, b, c4_full, ci2_full) -> List[int]:
    """Batched SHA256(a || b || c^4 || c_i^2) (thresholdkey.go:319-326)
    on device; returns one 256-bit challenge int per element.  All
    inputs are uint32 limb tensors [B, *]; byte layouts are the minimal
    big-endian encodings (Go Bytes() semantics, incl. zero -> empty)."""
    parts = [limbs_to_be_bytes(a), limbs_to_be_bytes(b),
             limbs_to_be_bytes(c4_full), limbs_to_be_bytes(ci2_full)]
    out_len = sum(p[0].shape[-1] for p in parts)
    buf, ln = concat_be(parts, out_len)
    digest = sha256_bytes(buf, ln, max_len=out_len)
    return digest_to_ints(digest)


def _unreduced_powers(c: jnp.ndarray, ci: jnp.ndarray, L: int):
    """Device full-width c^4 [B, 8L] and c_i^2 [B, 4L] (no reduction —
    the reference hashes the unreduced integers)."""
    c2 = vpu.mul(c, c, 4 * L)
    c4 = vpu.mul(c2, c2, 8 * L)
    ci2 = vpu.mul(ci, ci, 4 * L)
    return c4, ci2


def partial_decrypt_with_zkp(tsk: ThresholdSecretKey, ct: Ciphertext,
                             rng=None, window: int = 4
                             ) -> List[PartialDecryptionZKP]:
    """Batched PartialDecryptionWithZKP (thresholdkey.go:225-255).

    Device end-to-end: partial decryption, the two commitment ladders,
    the unreduced c^4/c_i^2 limb products and the batched SHA-256
    challenges; per-element host work is only z = r + e*delta*s."""
    rng = rng or prand.make_rng()
    dk = tsk.device()
    L = dk.L

    pd = partial_decrypt(tsk, ct, window)
    c = ct.c.reshape((-1, 2 * L))
    ci = pd.c.reshape((-1, 2 * L))
    B = c.shape[0]

    rs = [rng.randrange(tsk.n2) for _ in range(B)]
    # device digit extraction needs window | 16 (limb width)
    window = window if host.LIMB_BITS % window == 0 else 4

    # c^4 mod n^2 (ladder base) + the unreduced c^4 / c_i^2 for hashing
    ctx2 = dk.ctx_n2
    c2m = mont.modmul(ctx2, c, c)
    c4m = mont.modmul(ctx2, c2m, c2m)
    c4_full, ci2_full = _unreduced_powers(c, ci, L)

    r_limbs = encode_batch(rs, 2 * L)
    r_digits = mont.limbs_to_digits(r_limbs, window)
    a = dk.pow(1, c4m, r_digits, window)
    vbase = jnp.broadcast_to(jnp.asarray(host.int_to_limbs(tsk.v, 2 * L)),
                             c4m.shape)
    b = dk.pow(1, vbase, r_digits, window)

    es = _zkp_challenges(a, b, c4_full, ci2_full)
    ci_vals = decode_batch(ci)
    c_vals = decode_batch(c)

    ds = tsk.delta * tsk.share
    key_pub = tsk.public()
    return [PartialDecryptionZKP(
        id=tsk.id, decryption=ci_vals[j], key=key_pub, e=es[j],
        z=rs[j] + es[j] * ds,            # thresholdkey.go:313-317
        c=c_vals[j]) for j in range(B)]


def verify_proofs(proofs: Sequence[PartialDecryptionZKP],
                  window: int = 4) -> List[bool]:
    """Batched device VerifyProof (thresholdkey.go:278-311).

    a = (c^4)^z * (c_i^2)^{-e}, b = V^z * (v_i)^{-e} mod n^2, then the
    batched device SHA-256 recomputes the challenges.  Negative
    exponents become one native batched inverse + a short 256-bit
    ladder (t^{-e} = (t^{-1})^e).  All proofs must share one public
    key."""
    if not proofs:
        return []
    tpk = proofs[0].key
    dk = tpk.device()
    L = dk.L
    n2 = tpk.n2
    ctx2 = dk.ctx_n2
    B = len(proofs)
    window = window if host.LIMB_BITS % window == 0 else 4

    c = encode_batch([p.c for p in proofs], 2 * L)
    ci = encode_batch([p.decryption for p in proofs], 2 * L)
    c2m = mont.modmul(ctx2, c, c)
    c4m = mont.modmul(ctx2, c2m, c2m)
    ci2m = mont.modmul(ctx2, ci, ci)
    c4_full, ci2_full = _unreduced_powers(c, ci, L)

    # per-element z digits, extracted on device from the limb encoding
    zs = [p.z for p in proofs]
    es = [p.e for p in proofs]
    z_bits = max(max(z.bit_length() for z in zs), 1)
    zw = -(-z_bits // host.LIMB_BITS)
    z_digits = mont.limbs_to_digits(encode_batch(zs, zw), window)
    e_digits = mont.limbs_to_digits(
        encode_batch(es, 256 // host.LIMB_BITS), window)

    # one batched native inverse for both negative-exponent bases
    ci2_inv = host.modinv_batch(decode_batch(ci2m), n2)
    vi_inv = host.modinv_batch([tpk.vi[p.id - 1] for p in proofs], n2)

    a = mont.modmul(ctx2, dk.pow(1, c4m, z_digits, window),
                    dk.pow(1, encode_batch(ci2_inv, 2 * L),
                           e_digits, window))
    vbase = jnp.broadcast_to(
        jnp.asarray(host.int_to_limbs(tpk.v, 2 * L)), c4m.shape)
    b = mont.modmul(ctx2, dk.pow(1, vbase, z_digits, window),
                    dk.pow(1, encode_batch(vi_inv, 2 * L),
                           e_digits, window))

    got = _zkp_challenges(a, b, c4_full, ci2_full)
    return [g == e for g, e in zip(got, es)]


def verify_proof(pd: PartialDecryptionZKP) -> bool:
    """VerifyProof (thresholdkey.go:278-311), host control-plane
    single-proof variant (the batched device path is
    :func:`verify_proofs`)."""
    tpk = pd.key
    n2 = tpk.n2
    c4 = pd.c ** 4
    ci2 = pd.decryption ** 2
    # a = (c^4)^Z * (c_i^2)^{-E} mod n^2
    a = (pow(c4 % n2, pd.z, n2)
         * host.modinv(pow(ci2 % n2, pd.e, n2), n2)) % n2
    # b = V^Z * (v_i)^{-E} mod n^2
    vi = tpk.vi[pd.id - 1]
    b = (pow(tpk.v, pd.z, n2)
         * host.modinv(pow(vi, pd.e, n2), n2)) % n2
    return zkp_hash(a, b, c4, ci2) == pd.e


def verify_partial_decryption(tsk: ThresholdSecretKey, rng=None) -> None:
    """Self-test of one share (reference VerifyPartialDecryption,
    thresholdkey.go:258-275): encrypt a random message under the public
    key, produce this share's ZKP partial decryption, and verify the
    proof.  Raises ValueError("Invalid share") on failure."""
    from ..core.encrypt import Encryptor
    rng = rng or prand.make_rng()
    m = rng.randrange(tsk.n)
    ct = Encryptor(tsk.public(), rng=rng).encrypt([m])
    proofs = partial_decrypt_with_zkp(tsk, ct, rng)
    if not all(verify_proofs(proofs)):
        raise ValueError("Invalid share")


def combine_with_zkp(tpk: ThresholdPublicKey,
                     proofs_per_server: Sequence[Sequence[PartialDecryptionZKP]],
                     window: int = 4) -> List[int]:
    """CombinePartialDecryptionsZKP (thresholdkey.go:164-172): filter
    shares whose proofs fail (batched device verification per server),
    then combine the survivors."""
    from .decrypt import combine
    dk = tpk.device()
    L = dk.L
    valid_batches = []
    for proofs in proofs_per_server:
        if all(verify_proofs(proofs, window)):
            vals = [p.decryption for p in proofs]
            valid_batches.append(PartialDecryptionBatch(
                id=proofs[0].id, c=encode_batch(vals, 2 * L)))
    return combine(tpk, valid_batches, window)


def verify_decryption(tpk: ThresholdPublicKey, encrypted: int, decrypted: int,
                      proofs: Sequence[PartialDecryptionZKP]) -> None:
    """VerifyDecryption (thresholdkey.go:175-189): end-to-end check that
    ``proofs`` decrypt ``encrypted`` to ``decrypted``."""
    from .decrypt import combine_ints, verify_partial_decryptions
    for p in proofs:
        if p.c != encrypted:
            raise ValueError("The encrypted message is not the same than "
                             "the one in the shares")
    oks = verify_proofs(proofs)
    survivors = [PartialDecryption(id=p.id, decryption=p.decryption)
                 for p, ok in zip(proofs, oks) if ok]
    res = combine_ints(tpk, survivors)
    if res != decrypted:
        raise ValueError("The decrypted message is not the same than the "
                         "one in the shares")
