"""Core Paillier roundtrip + bit-exactness tests.

Mirrors the reference's randomized roundtrip strategy
(paillier_test.go:52-156) with a seeded deterministic RNG, and checks
bit-exact agreement with direct Python-int evaluation of the reference
formulas (the "Go vector" oracle)."""

import math
import random

import numpy as np
import pytest

from paillier_tpu.core import homomorphic as hom
from paillier_tpu.core.decrypt import (Decryptor, decrypt_nested_layer,
                                       nested_decrypt)
from paillier_tpu.core.encrypt import Encryptor, nested_encrypt
from paillier_tpu.core.keygen import keygen
from paillier_tpu.core.keys import (LEVEL_ONE, LEVEL_TWO, Ciphertext,
                                    decode_batch)

R = random.Random(99)


class TestKeygen:
    def test_structure(self, keypair_128):
        sk, pk = keypair_128
        assert pk.n.bit_length() == 128
        assert pk.g == pk.n + 1
        assert sk.p % 4 == 3 and sk.q % 4 == 3   # paillier.go:131-137
        assert sk.p != sk.q
        assert sk.lam == (sk.p - 1) * (sk.q - 1)
        assert pk.k == 1 << 64
        # h is a quadratic residue generator: h^lambda == 1 mod n
        assert pow(pk.h, sk.lam, pk.n) == 1      # paillier_test.go:29-50

    def test_validation(self):
        with pytest.raises(ValueError):
            keygen(63)
        with pytest.raises(ValueError):
            keygen(65)
        with pytest.raises(ValueError):
            keygen(32)


def test_device_batched_prime_and_keygen_routing():
    """device_batched_prime finds primes (batched Fermat on device +
    host MR confirm), and keygen can route its prime search through it
    (the auto path engages for bits >= 2048 without the native runtime)."""
    from paillier_tpu.core.keygen import device_batched_prime
    rng = random.Random(0xD0E1)
    p = device_batched_prime(96, rng, congruent_3_mod_4=True, batch=16)
    assert p.bit_length() == 96 and p % 4 == 3
    assert pow(2, p - 1, p) == 1
    # explicit routing through the device path end-to-end
    sk, pk = keygen(64, random.Random(0xD0E2), device_primes=True)
    assert pk.n.bit_length() == 64
    assert sk.p % 4 == 3 and sk.q % 4 == 3


def test_L_function_kat():
    """L(21, 3) = (21-1)/3 = 6 (paillier_test.go:20-27; L at
    paillier.go:437-440 uses truncated Div).  The device `_L_div` path is
    exact Hensel division (decryption only ever divides exactly), so it
    is checked on the exact case L(22, 3) = 7."""
    import jax.numpy as jnp
    from paillier_tpu.bigint import host
    from paillier_tpu.core.decrypt import _L_div
    from paillier_tpu.threshold.decrypt import L_int
    assert L_int(21, 3) == 6
    L = 4
    hensel = jnp.asarray(host.int_to_limbs(host.hensel_inverse(3, L), L))
    u_minus_1 = jnp.asarray(host.ints_to_limbs([22 - 1], L))
    out = host.limbs_to_ints(np.asarray(_L_div(u_minus_1, hensel, L)))
    assert out == [7]


class TestRoundtrip:
    def test_level1(self, keypair_128, rng):
        sk, pk = keypair_128
        enc = Encryptor(pk, LEVEL_ONE, rng=rng)
        dec = Decryptor(sk, LEVEL_ONE)
        ms = [rng.randrange(pk.n) for _ in range(5)] + [0, 1, pk.n - 1]
        assert dec.decrypt(enc.encrypt(ms)) == ms

    def test_level1_crt(self, keypair_128, rng):
        sk, pk = keypair_128
        enc = Encryptor(pk, LEVEL_ONE, rng=rng)
        dec = Decryptor(sk, LEVEL_ONE, crt=True)
        ms = [rng.randrange(pk.n) for _ in range(5)] + [0, 1, pk.n - 1]
        assert dec.decrypt(enc.encrypt(ms)) == ms

    def test_level2(self, keypair_128, rng):
        sk, pk = keypair_128
        enc = Encryptor(pk, LEVEL_TWO, rng=rng)
        dec = Decryptor(sk, LEVEL_TWO)
        # level-2 plaintexts up to n^2 - i (paillier_test.go:78-90)
        ms = ([rng.randrange(pk.n2) for _ in range(3)]
              + [0, 1, pk.n, pk.n2 - 1, pk.n2 - 5])
        assert dec.decrypt(enc.encrypt(ms)) == ms

    def test_bit_exact_vs_reference_formula(self, keypair_128, rng):
        """EncryptWithR parity: c = g^m r^(n^s) mod n^(s+1)
        (paillier.go:206-218)."""
        sk, pk = keypair_128
        ms = [rng.randrange(pk.n) for _ in range(8)]
        rs = [rng.randrange(2, pk.n) for _ in range(8)]
        enc = Encryptor(pk, LEVEL_ONE, rng=rng)
        got = decode_batch(enc.encrypt(ms, rs).c)
        exp = [(pow(pk.g, m, pk.n2) * pow(r, pk.n, pk.n2)) % pk.n2
               for m, r in zip(ms, rs)]
        assert got == exp

        enc2 = Encryptor(pk, LEVEL_TWO, rng=rng)
        ms2 = [rng.randrange(pk.n2) for _ in range(8)]
        got = decode_batch(enc2.encrypt(ms2, rs).c)
        exp = [(pow(pk.g, m, pk.n3) * pow(r, pk.n2, pk.n3)) % pk.n3
               for m, r in zip(ms2, rs)]
        assert got == exp

    def test_alternative_encryption(self, keypair_128, rng):
        """AltEncryptWithRAtLevel parity (paillier.go:221-238):
        c = g^m h_s^(r mod K) mod n^(s+1)."""
        sk, pk = keypair_128
        ms = [rng.randrange(pk.n) for _ in range(8)]
        rs = [rng.randrange(2, pk.n) for _ in range(8)]
        enc = Encryptor(pk, LEVEL_ONE, method="alternative", rng=rng)
        got = decode_batch(enc.encrypt(ms, rs).c)
        h1 = pow(pk.n - pk.h, pk.n, pk.n2)
        exp = [(pow(pk.g, m, pk.n2) * pow(h1, r % pk.k, pk.n2)) % pk.n2
               for m, r in zip(ms, rs)]
        assert got == exp
        # and they decrypt correctly
        dec = Decryptor(sk, LEVEL_ONE)
        assert dec.decrypt(enc.encrypt(ms)) == ms

        enc2 = Encryptor(pk, LEVEL_TWO, method="alternative", rng=rng)
        h2 = pow(pk.n2 - pk.h, pk.n2, pk.n3)
        ms2 = [rng.randrange(pk.n2) for _ in range(8)]
        got = decode_batch(enc2.encrypt(ms2, rs).c)
        exp = [(pow(pk.g, m, pk.n3) * pow(h2, r % pk.k, pk.n3)) % pk.n3
               for m, r in zip(ms2, rs)]
        assert got == exp

    def test_nested(self, keypair_128, rng):
        sk, pk = keypair_128
        ms = [rng.randrange(pk.n) for _ in range(4)]
        ctn = nested_encrypt(pk, ms, rng)
        assert ctn.level == LEVEL_TWO
        inner = decrypt_nested_layer(sk, ctn)
        assert inner.level == LEVEL_ONE
        assert nested_decrypt(sk, ctn) == ms

    def test_nested_layer_level1_raises(self, keypair_128, rng):
        sk, pk = keypair_128
        enc = Encryptor(pk, LEVEL_ONE, rng=rng)
        ct = enc.encrypt([1])
        with pytest.raises(ValueError):
            decrypt_nested_layer(sk, ct)


class TestHomomorphic:
    def test_add_sub_many(self, keypair_128, rng):
        sk, pk = keypair_128
        enc = Encryptor(pk, LEVEL_ONE, rng=rng)
        dec = Decryptor(sk, LEVEL_ONE)
        xs = [rng.randrange(pk.n) for _ in range(8)]
        ys = [rng.randrange(pk.n) for _ in range(8)]
        zs = [rng.randrange(pk.n) for _ in range(8)]
        cx, cy, cz = enc.encrypt(xs), enc.encrypt(ys), enc.encrypt(zs)
        got = dec.decrypt(hom.add(pk, cx, cy, cz))
        assert got == [(x + y + z) % pk.n for x, y, z in zip(xs, ys, zs)]
        got = dec.decrypt(hom.sub(pk, cx, cy, cz))
        assert got == [(x - y - z) % pk.n for x, y, z in zip(xs, ys, zs)]

    def test_const_mult(self, keypair_128, rng):
        sk, pk = keypair_128
        enc = Encryptor(pk, LEVEL_ONE, rng=rng)
        dec = Decryptor(sk, LEVEL_ONE)
        xs = [rng.randrange(pk.n) for _ in range(8)]
        cx = enc.encrypt(xs)
        got = dec.decrypt(hom.const_mult(pk, cx, 7))
        assert got == [(7 * x) % pk.n for x in xs]
        ks = [rng.randrange(pk.n) for _ in range(8)]
        got = dec.decrypt(hom.const_mult(pk, cx, ks))
        assert got == [(k * x) % pk.n for k, x in zip(ks, xs)]

    def test_aggregate(self, keypair_128, rng):
        sk, pk = keypair_128
        enc = Encryptor(pk, LEVEL_ONE, rng=rng)
        dec = Decryptor(sk, LEVEL_ONE)
        vals = [rng.randrange(1000) for _ in range(64)]
        cts = enc.encrypt(vals)
        for M in (1, 2, 3, 17, 64):
            agg = hom.aggregate(
                pk, Ciphertext(c=cts.c[:M], level=LEVEL_ONE), axis=0)
            got = dec.decrypt(Ciphertext(c=agg.c[None], level=LEVEL_ONE))
            assert got == [sum(vals[:M]) % pk.n], f"M={M}"

    def test_aggregate_streaming(self, keypair_128, rng):
        # chunked/streaming aggregation matches the one-shot tree
        # (config #3 through the library API)
        sk, pk = keypair_128
        enc = Encryptor(pk, LEVEL_ONE, rng=rng)
        dec = Decryptor(sk, LEVEL_ONE)
        vals = [rng.randrange(1000) for _ in range(48)]
        cts = enc.encrypt(vals)
        chunks = (Ciphertext(c=cts.c[i:i + 16], level=LEVEL_ONE)
                  for i in range(0, 48, 16))
        agg = hom.aggregate_streaming(pk, chunks)
        got = dec.decrypt(Ciphertext(c=agg.c[None], level=LEVEL_ONE))
        assert got == [sum(vals) % pk.n]

    def test_nested_ops(self, keypair_128, rng):
        sk, pk = keypair_128
        xs = [rng.randrange(pk.n) for _ in range(4)]
        ys = [rng.randrange(pk.n) for _ in range(4)]
        ctn = nested_encrypt(pk, xs, rng)
        enc = Encryptor(pk, LEVEL_ONE, rng=rng)
        ct1 = enc.encrypt(ys)
        assert nested_decrypt(sk, hom.nested_add(pk, ctn, ct1)) == [
            (x + y) % pk.n for x, y in zip(xs, ys)]
        assert nested_decrypt(sk, hom.nested_sub(pk, ctn, ct1)) == [
            (x - y) % pk.n for x, y in zip(xs, ys)]

    def test_nested_randomize_relation(self, keypair_128, rng):
        """ct2 = ct1^(a^n mod n^2) * b^(n^2) mod n^3 — the DDLEQ input
        relation (operations.go:96-118, ddleq.go:62-69)."""
        sk, pk = keypair_128
        xs = [rng.randrange(pk.n) for _ in range(3)]
        ctn = nested_encrypt(pk, xs, rng)
        ct2, a_l, b_l = hom.nested_randomize(pk, ctn, rng)
        assert nested_decrypt(sk, ct2) == xs
        for c1, c2, a, b in zip(decode_batch(ctn.c), decode_batch(ct2.c),
                                a_l, b_l):
            an = pow(a, pk.n, pk.n2)
            assert c2 == (pow(c1, an, pk.n3) * pow(b, pk.n2, pk.n3)) % pk.n3

    def test_extract_randomness(self, keypair_128, rng):
        """operations.go:75-91, both levels (operations_test.go:130-163)."""
        sk, pk = keypair_128
        xs = [rng.randrange(pk.n) for _ in range(4)]
        rs = []
        while len(rs) < 4:
            r = rng.randrange(2, pk.n)
            if math.gcd(r, pk.n) == 1:
                rs.append(r)
        for level in (LEVEL_ONE, LEVEL_TWO):
            enc = Encryptor(pk, level, rng=rng)
            ct = enc.encrypt(xs, rs)
            assert hom.extract_randomness(sk, ct) == rs, f"level {level}"
