"""Threshold scheme tests: reference KATs (thresholdkey_test.go) plus
batched end-to-end flows simulating all servers in-process, as the
reference does (thresholdkey_test.go:215-237, 329-355)."""

import random

import numpy as np
import pytest

from paillier_tpu.core import homomorphic as hom
from paillier_tpu.core.encrypt import Encryptor
from paillier_tpu.core.keys import LEVEL_ONE, decode_batch, encode_batch
from paillier_tpu.threshold.decrypt import (PartialDecryptionBatch, combine,
                                            combine_ints, compute_lambda,
                                            go_div, partial_decrypt,
                                            partial_decrypt_int,
                                            verify_partial_decryptions)
from paillier_tpu.threshold.keygen import (ThresholdKeyGenerator,
                                           generate_threshold_keys)
from paillier_tpu.threshold.keys import (PartialDecryption,
                                         PartialDecryptionZKP,
                                         ThresholdPublicKey,
                                         ThresholdSecretKey)
from paillier_tpu.threshold.safe_prime import (SafePrimeTimeout,
                                               generate_safe_prime,
                                               is_safe_prime)
from paillier_tpu.threshold.zkp import (combine_with_zkp,
                                        partial_decrypt_with_zkp,
                                        verify_decryption,
                                        verify_partial_decryption,
                                        verify_proof)

R = random.Random(31337)


@pytest.fixture(scope="module")
def tkeys(rng):
    """(l=5, t=3) threshold keys at 64-bit modulus."""
    return generate_threshold_keys(64, 5, 3, rng)


def _tpk(**kw):
    defaults = dict(n=1, g=2, h=0, k=0, bits=1)
    defaults.update(kw)
    return ThresholdPublicKey(**defaults)


class TestKats:
    """Deterministic known-answer tests replicated from the reference."""

    def test_delta(self):
        # thresholdkey_test.go:24-30
        assert _tpk(l=6).delta == 720

    def test_combine_shares_constant(self):
        # thresholdkey_test.go:48-56
        assert _tpk(n=101 * 103, l=6).combine_shares_constant == 4558

    def test_partial_decrypt_kat(self):
        # thresholdkey_test.go:58-74
        key = ThresholdSecretKey(n=101 * 103, g=0, h=0, k=0, bits=14,
                                 l=10, t=0, v=0, vi=(), id=9, share=862)
        pd = partial_decrypt_int(key, 56)
        assert pd.id == 9
        assert pd.decryption == 40644522

    def test_update_lambda(self):
        # thresholdkey_test.go:167-177: lambda=11, share1.ID=3,
        # share2.ID=7 -> 11 * (-7) / (3-7) = 20 (Euclidean div)
        assert go_div(11 * (-7), 3 - 7) == 20

    def test_update_cprime(self):
        # thresholdkey_test.go:179-189
        n = 99
        n2 = n * n
        cprime, lam, dec = 77, 52, 5
        got = (cprime * pow(dec, 2 * lam, n2)) % n2
        assert got == 8558

    def test_verify_parts(self):
        # thresholdkey_test.go:109-135
        n2 = 131 * 131
        c, dec, e, z = 99, 101, 112, 88
        c4 = c ** 4
        ci2 = dec ** 2
        a = (pow(c4 % n2, z, n2) * pow(pow(ci2 % n2, e, n2), -1, n2)) % n2
        assert a == 11986
        v, vi = 101, 77
        b = (pow(v, z, n2) * pow(pow(vi, e, n2), -1, n2)) % n2
        assert b == 14602

    def test_full_combine_kat(self):
        # thresholdkey_test.go:267-281: fixed shares -> 100
        tpk = _tpk(n=637753, l=2, t=2, v=70661107826)
        shares = [PartialDecryption(1, 384111638639),
                  PartialDecryption(2, 235243761043)]
        assert combine_ints(tpk, shares) == 100

    def test_compute_share(self):
        # thresholdkey_generator_test.go:282-294: f(x) = 29 + 88x + 51x^2
        # mod 103 evaluated for authority index 2 (i.e. x = 3) -> 31
        from paillier_tpu.threshold.keygen import compute_share
        assert compute_share([29, 88, 51], 2, 103) == 31

    def test_create_verification_keys(self):
        # thresholdkey_generator_test.go:314-324: l=10 (delta=10!), v=54,
        # n^2=101^2, shares [12, 90, 103] -> [6162, 304, 2728]
        from paillier_tpu.bigint.host import factorial
        gen = ThresholdKeyGenerator(32, 10, 3, random.Random(0))
        expect = [6162, 304, 2728]
        for device in (True, False):
            gen.device_verification_keys = device
            got = gen._verification_keys(54, [12, 90, 103],
                                         factorial(10), 101 * 101)
            assert got == expect, (device, got)

    def test_exp_with_negative(self):
        # thresholdkey_test.go:32-46
        assert pow(720, 10, 49) == 43
        assert pow(pow(720, 10, 49), -1, 49) == 8

    def test_verify_partial_decryptions_validation(self):
        # thresholdkey_test.go:150-165
        tpk = _tpk(t=2)
        with pytest.raises(ValueError):
            verify_partial_decryptions(tpk, [])
        ok = [PartialDecryption(0, 0), PartialDecryption(1, 0)]
        verify_partial_decryptions(tpk, ok)
        dup = [PartialDecryption(0, 0), PartialDecryption(0, 0)]
        with pytest.raises(ValueError):
            verify_partial_decryptions(tpk, dup)


class TestSafePrime:
    def test_generate(self, rng):
        p, q = generate_safe_prime(32, rng=rng)
        assert p == 2 * q + 1
        assert p.bit_length() == 32
        assert is_safe_prime(p)

    def test_too_small(self):
        with pytest.raises(ValueError):
            generate_safe_prime(5)

    def test_timeout(self, rng):
        with pytest.raises(SafePrimeTimeout):
            generate_safe_prime(64, timeout=0.0, rng=rng)


class TestGenerator:
    def test_validation(self):
        with pytest.raises(ValueError):
            ThresholdKeyGenerator(19, 4, 3)
        with pytest.raises(ValueError):
            ThresholdKeyGenerator(16, 4, 3)
        ThresholdKeyGenerator(18, 4, 3)
        ThresholdKeyGenerator(20, 6, 5)

    def test_key_structure(self, tkeys):
        # key-set shape (thresholdkey_generator_test.go:337-365)
        assert len(tkeys) == 5
        assert [k.id for k in tkeys] == [1, 2, 3, 4, 5]
        k0 = tkeys[0]
        assert k0.g == k0.n + 1
        assert k0.n.bit_length() == 64
        assert len(k0.vi) == 5
        # verification keys match v^(delta * share) mod n^2
        for k in tkeys:
            assert k.vi[k.id - 1] == pow(k0.v, k0.delta * k.share, k0.n2)

    def test_d_properties(self, rng):
        # d == 0 mod m, d == 1 mod n (thresholdkey_generator_test.go:232-243)
        gen = ThresholdKeyGenerator(48, 3, 2, rng)
        p, p1, q, q1 = gen._init_ps_and_qs()
        n, m = p * q, p1 * q1
        d = (pow(m, -1, n) * m) % (n * m)
        assert d % m == 0
        assert d % n == 1


class TestEndToEnd:
    def test_batched_threshold_roundtrip(self, tkeys, rng):
        tpk = tkeys[0].public()
        enc = Encryptor(tpk, LEVEL_ONE, rng=rng)
        ms = [rng.randrange(tpk.n) for _ in range(6)] + [0, 100]
        ct = enc.encrypt(ms)
        # any t=3 of the 5 servers decrypt
        shares = [partial_decrypt(tkeys[i], ct) for i in (0, 2, 4)]
        assert combine(tpk, shares) == ms

    def test_all_five_servers(self, tkeys, rng):
        tpk = tkeys[0].public()
        enc = Encryptor(tpk, LEVEL_ONE, rng=rng)
        ms = [13, 19]
        ct = enc.encrypt(ms)
        shares = [partial_decrypt(k, ct) for k in tkeys]
        assert combine(tpk, shares) == ms

    def test_homomorphic_then_threshold(self, tkeys, rng):
        # thresholdkey_test.go:238-266
        tpk = tkeys[0].public()
        enc = Encryptor(tpk, LEVEL_ONE, rng=rng)
        c1, c2 = enc.encrypt([13]), enc.encrypt([19])
        c3 = hom.add(tpk, c1, c2)
        shares = [partial_decrypt(tkeys[i], c3) for i in (1, 3, 4)]
        assert combine(tpk, shares) == [32]

    def test_partial_decrypt_all_matches_per_server(self, tkeys, rng):
        """The stacked one-dispatch partial path is bit-identical to
        t separate partial_decrypt calls."""
        import numpy as np
        from paillier_tpu.threshold.decrypt import partial_decrypt_all
        tpk = tkeys[0].public()
        enc = Encryptor(tpk, LEVEL_ONE, rng=rng)
        ms = [rng.randrange(tpk.n) for _ in range(4)]
        ct = enc.encrypt(ms)
        subset = [tkeys[0], tkeys[2], tkeys[4]]
        stacked = partial_decrypt_all(subset, ct)
        for got, k in zip(stacked, subset):
            ref = partial_decrypt(k, ct)
            assert got.id == ref.id
            assert (np.asarray(got.c) == np.asarray(ref.c)).all()
        assert combine(tpk, stacked) == ms

    def test_generate_from_primes_rejects_bad_fixtures(self, rng):
        gen = ThresholdKeyGenerator(18, 3, 2, rng)
        with pytest.raises(ValueError):
            gen.generate_from_primes(9, 4, 7, 3)       # 9 not prime
        with pytest.raises(ValueError):
            gen.generate_from_primes(11, 4, 7, 3)      # 11 != 2*4+1

    def test_below_threshold_fails(self, tkeys, rng):
        tpk = tkeys[0].public()
        enc = Encryptor(tpk, LEVEL_ONE, rng=rng)
        ct = enc.encrypt([5])
        shares = [partial_decrypt(tkeys[0], ct)]
        with pytest.raises(ValueError):
            combine(tpk, shares)


class TestZkp:
    def test_prove_verify_roundtrip(self, tkeys, rng):
        tpk = tkeys[0].public()
        enc = Encryptor(tpk, LEVEL_ONE, rng=rng)
        ms = [876, 3]
        ct = enc.encrypt(ms)
        proofs = [partial_decrypt_with_zkp(tkeys[i], ct, rng)
                  for i in (0, 1, 2)]
        for server_proofs in proofs:
            for p in server_proofs:
                assert verify_proof(p)
        assert combine_with_zkp(tpk, proofs) == ms

    def test_tampered_proof_rejected(self, tkeys, rng):
        # thresholdkey_test.go:322-326
        tpk = tkeys[0].public()
        enc = Encryptor(tpk, LEVEL_ONE, rng=rng)
        ct = enc.encrypt([100])
        proofs = [partial_decrypt_with_zkp(tkeys[i], ct, rng)
                  for i in (0, 1, 2, 3)]
        proofs[0][0].e = 687687678
        assert not verify_proof(proofs[0][0])
        # filtered out, but enough remain -> still decrypts
        assert combine_with_zkp(tpk, proofs) == [100]

    def test_verify_partial_decryption_self_test(self, tkeys, rng):
        # thresholdkey.go:258-275: each share self-verifies; a corrupted
        # share does not
        verify_partial_decryption(tkeys[0], rng)
        import dataclasses
        bad = dataclasses.replace(tkeys[1], share=tkeys[1].share + 1)
        with pytest.raises(ValueError, match="Invalid share"):
            verify_partial_decryption(bad, rng)

    def test_verify_decryption(self, tkeys, rng):
        # thresholdkey_test.go:357-394
        tpk = tkeys[0].public()
        enc = Encryptor(tpk, LEVEL_ONE, rng=rng)
        ct = enc.encrypt([101])
        cval = decode_batch(ct.c)[0]
        proofs = [partial_decrypt_with_zkp(tkeys[i], ct, rng)[0]
                  for i in (0, 1, 2)]
        verify_decryption(tpk, cval, 101, proofs)
        with pytest.raises(ValueError):
            verify_decryption(tpk, cval, 100, proofs)
        with pytest.raises(ValueError):
            verify_decryption(tpk, cval + 1, 101, proofs)
