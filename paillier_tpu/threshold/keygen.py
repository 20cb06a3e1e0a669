"""Threshold key generation (reference: thresholdkey_generator.go:19-278).

Two safe-prime pairs p = 2p1+1, q = 2q1+1; n = pq, m = p1q1;
d == 1 (mod n), d == 0 (mod m) via CRT; a random degree-(t-1) Shamir
polynomial over Z_nm with a0 = d; share_i = f(i+1) mod nm; verification
keys v_i = v^(delta * s_i) mod n^2.

Control-plane steps (primes, polynomial, shares) run on host; the l
verification-key modexps are batched on device with per-element exponent
digits — the batched replacement for the reference's sequential loop
(thresholdkey_generator.go:246-254).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from ..bigint import host
from ..bigint import montgomery as mont
from ..ops import random as prand
from .keys import ThresholdSecretKey
from .safe_prime import generate_safe_prime


@dataclass
class ThresholdKeyGenerator:
    bits: int
    l: int                      # total number of decryption servers
    t: int                      # threshold
    rng: object = None
    timeout: Optional[float] = None   # None -> Config.keygen_timeout
    device_verification_keys: bool = True

    def __post_init__(self):
        # validation mirrors NewThresholdKeyGenerator
        # (thresholdkey_generator.go:62-86)
        if self.timeout is None:
            from ..config import get_config
            self.timeout = get_config().keygen_timeout
        if self.bits % 2 == 1:
            raise ValueError("Public key bit length must be an even number")
        if self.bits < 18:
            raise ValueError("Public key bit length must be at least 18 bits")
        self.rng = self.rng or prand.make_rng()

    # -- numeric setup ----------------------------------------------------
    def _init_ps_and_qs(self):
        while True:
            p, p1 = generate_safe_prime(self.bits // 2, self.timeout, self.rng)
            q, q1 = generate_safe_prime(self.bits // 2, self.timeout, self.rng)
            # distinctness retry (thresholdkey_generator.go:120-144)
            if p != q and p != q1 and p1 != q:
                return p, p1, q, q1

    def generate(self) -> List[ThresholdSecretKey]:
        return self.generate_from_primes(*self._init_ps_and_qs())

    def generate_from_primes(self, p: int, p1: int, q: int, q1: int
                             ) -> List[ThresholdSecretKey]:
        """Key generation from caller-supplied safe-prime pairs
        p = 2*p1 + 1, q = 2*q1 + 1 (e.g. precomputed fixtures, so a
        benchmark measures decryption rather than prime-search luck).
        The polynomial/share/verification-key steps are identical to
        :meth:`generate` (thresholdkey_generator.go:177-278).

        Caller-supplied primes are fully validated (structure AND
        primality): a bad fixture would otherwise yield a silently
        insecure/incorrect threshold key."""
        from .safe_prime import is_safe_prime
        if p != 2 * p1 + 1 or q != 2 * q1 + 1:
            raise ValueError("primes must satisfy p = 2*p1+1, q = 2*q1+1")
        if not (is_safe_prime(p) and is_safe_prime(q)):
            raise ValueError("p and q must be safe primes")
        n = p * q
        m = p1 * q1
        nm = n * m
        n2 = n * n
        # d = 1 mod n, 0 mod m (thresholdkey_generator.go:177-180)
        d = (pow(m, -1, n) * m) % (nm)
        # v: QR generator of Z_{n^2} (thresholdkey_generator.go:147-151)
        v = prand.random_qr_generator(n2, self.rng)

        # hiding polynomial, a0 = d (thresholdkey_generator.go:197-209)
        coeffs = [d] + [self.rng.randrange(nm) for _ in range(self.t - 1)]

        # share_i = f(i+1) mod nm (thresholdkey_generator.go:213-231)
        shares = [compute_share(coeffs, i, nm) for i in range(self.l)]

        delta = host.factorial(self.l)
        vi = self._verification_keys(v, shares, delta, n2)

        keys = []
        for i in range(self.l):
            keys.append(ThresholdSecretKey(
                n=n, g=n + 1, h=0, k=0, bits=self.bits,
                l=self.l, t=self.t, v=v, vi=tuple(vi),
                id=i + 1, share=shares[i]))
        return keys

    def _verification_keys(self, v: int, shares: List[int], delta: int,
                           n2: int) -> List[int]:
        """v_i = v^(delta * s_i) mod n^2, batched on device
        (thresholdkey_generator.go:246-254)."""
        exps = [delta * s for s in shares]
        if not self.device_verification_keys:
            return [pow(v, e, n2) for e in exps]
        ctx = mont.make_mont_ctx(n2)
        L = ctx.n_limbs
        window = 4
        bits = max(e.bit_length() for e in exps) or 1
        nd = mont.n_digits_for_bits(bits, window)
        digits = jnp.asarray(np.stack(
            [mont.exp_digits(e, window, nd) for e in exps]))
        base = jnp.asarray(host.int_to_limbs(v, L))
        out = mont.mont_pow_fixed_base(ctx, base, digits, window)
        return host.limbs_to_ints(np.asarray(out))


def compute_share(coeffs: List[int], index: int, nm: int) -> int:
    """Share of authority ``index`` (0-based): f(index+1) mod nm over the
    hiding polynomial (reference: computeShare,
    thresholdkey_generator.go:213-223 — authorities are indexed from 1)."""
    x = index + 1
    return sum(a * pow(x, j) for j, a in enumerate(coeffs)) % nm


def generate_threshold_keys(bits: int, l: int, t: int, rng=None,
                            timeout: Optional[float] = None
                            ) -> List[ThresholdSecretKey]:
    """Convenience wrapper (reference: GenerateKeys,
    thresholdkey_generator.go:47-55)."""
    return ThresholdKeyGenerator(bits, l, t, rng, timeout).generate()
