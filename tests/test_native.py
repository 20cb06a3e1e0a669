"""Native C++/GMP host-math runtime: parity vs Python ints.

The native module mirrors the role libgmp plays in the reference (all
host big-int math; reference paillier.go:10 imports the CGo gmp
binding).  Every function must agree bit-for-bit with the pure-Python
control plane it replaces.
"""

import math
import random

import pytest

from paillier_tpu import native
from paillier_tpu.bigint import host
from paillier_tpu.threshold.safe_prime import generate_safe_prime, is_safe_prime

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain/libgmp unavailable")


def test_powm_parity():
    rng = random.Random(0xA11CE)
    for _ in range(100):
        m = rng.getrandbits(rng.randrange(8, 600)) | 1
        b = rng.getrandbits(512) % m
        e = rng.getrandbits(rng.randrange(1, 512))
        assert native.powm(b, e, m) == pow(b, e, m)


def test_powm_batch_parity_and_threads():
    rng = random.Random(3)
    m = rng.getrandbits(512) | 1
    e = rng.getrandbits(512)
    bases = [rng.getrandbits(512) for _ in range(17)]
    want = [pow(b, e, m) for b in bases]
    assert native.powm_batch(bases, e, m, threads=1) == want
    assert native.powm_batch(bases, e, m, threads=4) == want


def test_modinv_gcd_mulmod_parity():
    rng = random.Random(9)
    for _ in range(100):
        m = rng.getrandbits(300) | 1
        a = rng.getrandbits(280)
        b = rng.getrandbits(250)
        assert native.gcd(a, m) == math.gcd(a, m)
        assert native.mulmod(a, b, m) == (a * b) % m
        try:
            want = pow(a, -1, m)
        except ValueError:
            want = None
        if want is None:
            with pytest.raises(ValueError):
                native.modinv(a, m)
        else:
            assert native.modinv(a, m) == want


def test_modinv_batch_montgomery_trick():
    """Chunked Montgomery batch inversion: parity with pow(-1) for
    invertible batches, correct bad-element reporting via the
    per-element fallback, thread-count independence."""
    rng = random.Random(0xBA7C4)
    m = 0
    while True:        # an odd semiprime-ish modulus with small factor 7
        p = rng.getrandbits(200) | (1 << 199) | 1
        if host.is_probable_prime(p):
            break
    m = 7 * p
    vals = [rng.randrange(1, m) for _ in range(57)]
    vals = [v if math.gcd(v, m) == 1 else v + 1 for v in vals]
    vals = [v if math.gcd(v, m) == 1 else 11 for v in vals]
    want = [pow(v, -1, m) for v in vals]
    assert native.modinv_batch(vals, m) == want
    assert native.modinv_batch(vals, m, threads=1) == want
    assert native.modinv_batch(vals, m, threads=5) == want
    # a multiple of 7 is not invertible -> ValueError (counted via the
    # chunk fallback path)
    with pytest.raises(ValueError):
        native.modinv_batch(vals[:10] + [7 * 13] + vals[10:], m)


def test_probab_prime():
    known_primes = [2, 3, 5, 7919, (1 << 127) - 1, (1 << 521) - 1]
    known_composites = [1, 4, 561, 1105, (1 << 127) - 3, (1 << 256) + 1]
    for p in known_primes:
        assert native.is_probable_prime(p)
    for c in known_composites:
        assert not native.is_probable_prime(c)


def test_first_prime_plain():
    rng = random.Random(11)
    cands = [rng.getrandbits(256) | 1 for _ in range(64)]
    idx = native.first_prime(cands)
    want = next((i for i, c in enumerate(cands)
                 if host.is_probable_prime(c)), None)
    assert idx == want
    # deterministic across thread counts (lowest index wins, never a race)
    assert idx == native.first_prime(cands, threads=1)
    assert idx == native.first_prime(cands, threads=7)
    # all-composite batch -> None
    assert native.first_prime([4, 100, 561]) is None


def test_first_prime_safe():
    rng = random.Random(0xD00D)
    qbits = 191
    found = None
    while found is None:
        cands = [rng.getrandbits(qbits) | (1 << (qbits - 1))
                 | (1 << (qbits - 2)) | 1 for _ in range(512)]
        found = native.first_prime(cands, safe=True)
    q = cands[found]
    assert is_safe_prime(2 * q + 1)
    # every earlier candidate really fails the safe-prime test
    for c in cands[:found]:
        assert not is_safe_prime(2 * c + 1)
    assert found == native.first_prime(cands, safe=True, threads=3)


def test_generate_safe_prime_uses_native_path():
    rng = random.Random(0xD00D)
    p, q = generate_safe_prime(256, rng=rng)
    assert p == 2 * q + 1 and p.bit_length() == 256
    assert is_safe_prime(p)
    # deterministic per rng stream (candidates come from the caller's rng)
    p2, q2 = generate_safe_prime(256, rng=random.Random(0xD00D))
    assert (p2, q2) == (p, q)


def test_error_paths():
    with pytest.raises(ValueError):
        native.powm(3, 4, 0)
    with pytest.raises(ValueError):
        native.mulmod(3, 4, 0)
    with pytest.raises(ValueError):
        native.modinv(3, 0)


def test_host_wrappers_route_large_inputs():
    rng = random.Random(2)
    n = rng.getrandbits(1024) | 1
    a = rng.getrandbits(1000)
    try:
        want = pow(a, -1, n)
    except ValueError:
        want = None
    if want is not None:
        assert host.modinv(a, n) == want
    p = host.random_prime(128, rng=random.Random(4))
    assert host.is_probable_prime(p)
    q = host.random_prime(128, rng=random.Random(5))
    assert not host.is_probable_prime(p * q)
