"""Key generation (reference: paillier.go:106-179).

Draws two secparam/2-bit primes congruent to 3 mod 4 (rejecting p == q),
sets N = p*q, G = N+1, K = 2^(secparam/2), lambda = phi(N) = (p-1)(q-1),
and H = a random quadratic-residue generator mod N.

The prime search runs on host (control plane).  For large keys the
Miller-Rabin witnesses can be batched on device — see
:func:`device_batched_prime` which sieves candidates on host and runs one
batched Fermat/Miller-Rabin modexp kernel per round (the batched
version of the reference's goroutine concurrencyLevel,
safe_prime.go:61-105).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..bigint import host
from ..ops import random as prand
from .keys import PublicKey, SecretKey


def keygen(secparam: int, rng=None,
           device_primes: Optional[bool] = None
           ) -> Tuple[SecretKey, PublicKey]:
    """Generate a keypair; panics-as-exceptions match reference semantics
    (paillier.go:108-114).

    ``device_primes``: route the prime search through the batched device
    Fermat kernel (:func:`device_batched_prime`).  Default (None): auto —
    used for production key sizes (>= 2048 bits) when the native GMP
    runtime is unavailable, so large-key generation still gets batch
    parallelism (the batched analogue of the reference's goroutine race,
    safe_prime.go:61-105)."""
    if secparam % 2 != 0:
        raise ValueError("keygen: secparam must be divisible by 2")
    if secparam < 64:
        raise ValueError("keygen: secparam must be at least 64 bits")

    rng = rng or prand.make_rng()
    half = secparam // 2
    if device_primes is None:
        from .. import native
        device_primes = secparam >= 2048 and not native.available()
    while True:
        if device_primes:
            p = device_batched_prime(half, rng, congruent_3_mod_4=True)
            q = device_batched_prime(half, rng, congruent_3_mod_4=True)
        else:
            p = host.random_prime(half, congruent_3_mod_4=True, rng=rng)
            q = host.random_prime(half, congruent_3_mod_4=True, rng=rng)
        if p != q:
            break

    n = p * q
    lam = (p - 1) * (q - 1)
    g = n + 1
    k = 1 << half
    h = prand.random_qr_generator(n, rng)

    sk = SecretKey(n=n, g=g, h=h, k=k, bits=n.bit_length(),
                   lam=lam, p=p, q=q)
    return sk, sk.public()


# ---------------------------------------------------------------------------
# Device-batched primality: host sieve + one batched modexp round per draw
# ---------------------------------------------------------------------------

_SIEVE_PRIMES = [3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
                 59, 61, 67, 71, 73, 79, 83, 89, 97]


def sieve_candidates(bits: int, count: int, rng=None, *,
                     congruent_3_mod_4: bool = False) -> list[int]:
    """Random odd ``bits``-bit candidates surviving the small-prime sieve
    (the batch analogue of safe_prime.go:208-218's product-mod trick)."""
    rng = rng or prand.make_rng()
    out = []
    while len(out) < count:
        c = rng.getrandbits(bits) | (1 << (bits - 1)) | (1 << (bits - 2)) | 1
        if congruent_3_mod_4:
            c |= 2
        if any(c % sp == 0 for sp in _SIEVE_PRIMES):
            continue
        out.append(c)
    return out


def device_batched_prime(bits: int, rng=None, *, batch: int = 64,
                         congruent_3_mod_4: bool = False,
                         mr_rounds: int = 20) -> int:
    """Find a prime by testing a sieved batch of candidates per round with
    batched Fermat base-2 tests on device, then confirming the survivor
    with host Miller-Rabin.

    Each candidate has its own modulus, so the batch runs as a vmap over
    per-candidate Montgomery contexts; for the moderate key sizes used in
    tests the host path is competitive, so this is used when ``bits`` is
    large.
    """
    import jax
    import jax.numpy as jnp
    from ..bigint import montgomery as mont
    from ..bigint import vpu

    L = host.limbs_for_bits(bits)
    rng = rng or prand.make_rng()

    def fermat_batch(cands: list[int]) -> np.ndarray:
        # Per-candidate modulus: stack contexts and vmap the shared-exponent
        # ladder. Exponents differ per candidate -> per-element digits.
        ctxs = [mont.make_mont_ctx(c, L) for c in cands]
        ctx = mont.MontCtx(*[jnp.stack([getattr(c, f) for c in ctxs])
                             for f in mont.MontCtx._fields])
        base = jnp.broadcast_to(
            jnp.zeros((L,), jnp.uint32).at[0].set(2), (len(cands), L))
        exps = jnp.asarray(np.stack(
            [host.int_to_limbs(c - 1, L) for c in cands]))
        digits = mont.limbs_to_digits(exps, 4)
        res = jax.vmap(
            lambda cx, b, d: mont.mont_pow_digits(cx, b[None], d[None], 4)[0]
        )(ctx, base, digits)
        ones = np.zeros((L,), np.uint32)
        ones[0] = 1
        return np.all(np.asarray(jax.device_get(res)) == ones, axis=-1)

    while True:
        cands = sieve_candidates(bits, batch, rng,
                                 congruent_3_mod_4=congruent_3_mod_4)
        ok = fermat_batch(cands)
        for i in np.nonzero(ok)[0]:
            c = cands[int(i)]
            if host.is_probable_prime(c, mr_rounds):
                return c
