"""Safe (Sophie Germain) prime generation (reference: safe_prime.go:61-266).

The reference races goroutines and cancels on the first winner.  The
equivalent here is batch parallelism: draw a sieved batch of
candidates, reject q == 1 (mod 3) (which forces 3 | 2q+1), then run the
expensive primality tests — Miller-Rabin on q and a Pocklington/Fermat
base-2 test on p = 2q+1 — taking the first survivor.  For large bit
lengths the Fermat tests can run as one batched device modexp
(paillier_tpu.core.keygen.device_batched_prime); at the sizes used in
tests the host path wins.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

from ..bigint import host
from ..ops import random as prand

_SIEVE = [3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53]


class SafePrimeTimeout(Exception):
    pass


def _candidate(bits: int, rng) -> int:
    """Random odd ``bits``-bit value with the top two bits set
    (safe_prime.go:183-200)."""
    c = rng.getrandbits(bits) | (1 << (bits - 1)) | (1 << (bits - 2)) | 1
    return c


def generate_safe_prime(bits: int, timeout: float = 120.0, rng=None,
                        batch: int = 64) -> Tuple[int, int]:
    """Return (p, q) with p = 2q + 1 both prime, p of ``bits`` bits.

    Raises ValueError for bits < 6 and SafePrimeTimeout on expiry,
    mirroring the reference's error contract (safe_prime.go:67-69,
    95-104).
    """
    if bits < 6:
        raise ValueError("safe prime size must be at least 6 bits")
    rng = rng or prand.make_rng()
    qbits = bits - 1
    deadline = time.monotonic() + timeout

    # Native fast path: candidates are drawn *here* from the caller's
    # CSPRNG at full width (the reference reads crypto/rand per candidate,
    # safe_prime.go:175); the C++/GMP runtime only races std::threads over
    # the expensive tests and returns the lowest passing index, so the
    # result is deterministic per rng stream.  ~20x the Python loop at
    # 1024 bits.
    if bits >= 128:
        from paillier_tpu.bigint.host import _native
        nat = _native()
        if nat is not None:
            batch_n = 2048
            while time.monotonic() < deadline:
                cands = [_candidate(qbits, rng) for _ in range(batch_n)]
                idx = nat.first_prime(cands, safe=True, reps=20)
                if idx is not None:
                    q = cands[idx]
                    return 2 * q + 1, q
            raise SafePrimeTimeout(f"generator timed out after {timeout}s")

    while time.monotonic() < deadline:
        # batch of sieved q candidates (the "concurrencyLevel" analogue)
        cands = []
        while len(cands) < batch and time.monotonic() < deadline:
            q = _candidate(qbits, rng)
            if qbits > 6 and any(q % s == 0 for s in _SIEVE):
                continue
            # q == 1 (mod 3) forces p = 2q+1 == 0 (mod 3)
            # (safe_prime.go:225-241)
            if q % 3 == 1:
                continue
            p = 2 * q + 1
            if any(p % s == 0 and p != s for s in _SIEVE):
                continue
            cands.append((p, q))
        for p, q in cands:
            if q.bit_length() != qbits:
                continue
            if host.is_probable_prime(q, 20) and _pocklington(p):
                return p, q
    raise SafePrimeTimeout(f"generator timed out after {timeout}s")


def _pocklington(p: int) -> bool:
    """Fermat base-2: 2^(p-1) == 1 (mod p); with q prime this proves p
    prime by Pocklington's criterion (safe_prime.go:272-278)."""
    return pow(2, p - 1, p) == 1


def is_safe_prime(p: int) -> bool:
    """p and (p-1)/2 both prime (test helper, cf. utils_test.go:66-82)."""
    return (p % 2 == 1 and host.is_probable_prime(p)
            and host.is_probable_prime((p - 1) // 2))
