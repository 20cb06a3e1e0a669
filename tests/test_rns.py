"""RNS (Cox-Rower) engine tests against the Python-int oracle, plus the
device limb<->residue converters and the limb-Montgomery ladders."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from paillier_tpu.bigint import host
from paillier_tpu.bigint import montgomery as mont
from paillier_tpu.bigint.rns import RnsConverter, RnsEngine

R = random.Random(4242)


@pytest.fixture(scope="module")
def engine():
    p = host.random_prime(64)
    q = host.random_prime(64)
    N = (p * q) ** 2              # Paillier-style modulus n^2, 256-bit
    return RnsEngine(N)


class TestRnsCore:
    def test_range_conditions(self, engine):
        s = engine.spec
        k = s.k
        assert s.M >= (k + 1) * (k + 1) * s.N
        assert s.M2 >= (k + 1) * s.N
        assert len(set(s.all_m)) == len(s.all_m)

    def test_encode_decode(self, engine):
        N = engine.spec.N
        xs = [R.randrange(N) for _ in range(8)] + [0, 1, N - 1]
        assert engine.decode(engine.encode(xs)) == xs

    def test_mont_mul(self, engine):
        N = engine.spec.N
        Minv = pow(engine.spec.M, -1, N)
        xs = [R.randrange(N) for _ in range(8)]
        ys = [R.randrange(N) for _ in range(8)]
        got = engine.decode(engine.mont_mul(engine.encode(xs),
                                            engine.encode(ys)))
        assert got == [(x * y * Minv) % N for x, y in zip(xs, ys)]

    def test_pow_shared(self, engine):
        N = engine.spec.N
        xs = [R.randrange(N) for _ in range(8)]
        e = R.getrandbits(128)
        nd = mont.n_digits_for_bits(128, 4)
        digs = jnp.asarray(mont.exp_digits(e, 4, nd))
        got = engine.decode(engine.pow(engine.encode(xs), digs))
        assert got == [pow(x, e, N) for x in xs]

    def test_pow_per_element(self, engine):
        N = engine.spec.N
        xs = [R.randrange(N) for _ in range(8)]
        es = [R.getrandbits(64) for _ in range(8)]
        nd = mont.n_digits_for_bits(64, 4)
        digs = jnp.asarray(np.stack(
            [mont.exp_digits(ei, 4, nd) for ei in es]))
        got = engine.decode(engine.pow(engine.encode(xs), digs))
        assert got == [pow(x, ei, N) for x, ei in zip(xs, es)]

    def test_chained_invariant(self, engine):
        """50 chained multiplies stay exact (range invariant holds)."""
        N = engine.spec.N
        Minv = pow(engine.spec.M, -1, N)
        xs = [R.randrange(N) for _ in range(4)]
        ys = [R.randrange(N) for _ in range(4)]
        Z = engine.encode(xs)
        Y = engine.encode(ys)
        for _ in range(50):
            Z = engine.mont_mul(Z, Y)
        got = engine.decode(Z)
        assert got == [(x * pow(y * Minv % N, 50, N)) % N
                       for x, y in zip(xs, ys)]


class TestConverter:
    def test_roundtrip(self, engine):
        N = engine.spec.N
        L = host.limbs_for_bits(N.bit_length())
        conv = RnsConverter(engine, L)
        xs = [R.randrange(N) for _ in range(8)] + [0, 1]
        X = jnp.asarray(host.ints_to_limbs(xs, L))
        res = conv.from_limbs(X)
        assert engine.decode(res) == xs
        back = host.limbs_to_ints(np.asarray(conv.to_limbs(res)))
        assert back == xs

    def test_to_limbs_after_arithmetic(self, engine):
        N = engine.spec.N
        L = host.limbs_for_bits(N.bit_length())
        conv = RnsConverter(engine, L)
        xs = [R.randrange(N) for _ in range(4)]
        X = conv.from_limbs(jnp.asarray(host.ints_to_limbs(xs, L)))
        Y = engine.mont_mul(X, X)
        vals = engine.decode(Y)
        got = host.limbs_to_ints(np.asarray(conv.to_limbs(Y)))
        assert [g % N for g in got] == vals
        assert all(g < engine.spec.M for g in got)


class TestMontLadders:
    """The limb-Montgomery ladder entry points at edge exponents."""

    @pytest.fixture(scope="class")
    def ctx_n(self):
        n = host.random_prime(96) * host.random_prime(96)
        return mont.make_mont_ctx(n), n

    @pytest.mark.parametrize("e", [1, 2, 3])
    def test_pow_digits_edge_exponents(self, ctx_n, e):
        ctx, n = ctx_n
        xs = [R.randrange(n) for _ in range(4)]
        X = jnp.asarray(host.ints_to_limbs(xs, ctx.n_limbs))
        digs = jnp.asarray(mont.exp_digits(e, 4, 1))
        got = host.limbs_to_ints(np.asarray(
            mont.mont_pow_digits(ctx, X, digs, 4)))
        assert got == [pow(x, e, n) for x in xs]
        es = [e, 1, 2, 3]
        digs = jnp.asarray(np.stack([mont.exp_digits(v, 4, 1) for v in es]))
        got = host.limbs_to_ints(np.asarray(
            mont.mont_pow_digits(ctx, X, digs, 4)))
        assert got == [pow(x, v, n) for x, v in zip(xs, es)]

    @pytest.mark.parametrize("e", [1, 2, 3])
    def test_pow_fixed_base_edge_exponents(self, ctx_n, e):
        ctx, n = ctx_n
        g = R.randrange(2, n)
        G = jnp.asarray(host.int_to_limbs(g, ctx.n_limbs))
        es = [e, 0, R.getrandbits(40), (1 << 40) - 1]
        nd = mont.n_digits_for_bits(40, 4)
        digs = jnp.asarray(np.stack([mont.exp_digits(v, 4, nd) for v in es]))
        got = host.limbs_to_ints(np.asarray(
            mont.mont_pow_fixed_base(ctx, G, digs, 4)))
        assert got == [pow(g, v, n) for v in es]


class TestRnsPipelines:
    """Explicit engine='rns' must be bit-identical to the limb path."""

    def test_encrypt_rns_bit_exact(self, keypair_128, rng):
        from paillier_tpu.core.encrypt import Encryptor
        from paillier_tpu.core.keys import LEVEL_ONE, decode_batch
        sk, pk = keypair_128
        ms = [rng.randrange(pk.n) for _ in range(8)]
        rs = [rng.randrange(2, pk.n) for _ in range(8)]
        limb = Encryptor(pk, LEVEL_ONE, rng=rng, engine="limb")
        rnse = Encryptor(pk, LEVEL_ONE, rng=rng, engine="rns")
        a = decode_batch(limb.encrypt(ms, rs).c)
        b = decode_batch(rnse.encrypt(ms, rs).c)
        assert a == b

    def test_decrypt_rns(self, keypair_128, rng):
        from paillier_tpu.core.decrypt import Decryptor
        from paillier_tpu.core.encrypt import Encryptor
        from paillier_tpu.core.keys import LEVEL_ONE
        sk, pk = keypair_128
        ms = [rng.randrange(pk.n) for _ in range(8)]
        enc = Encryptor(pk, LEVEL_ONE, rng=rng, engine="limb")
        ct = enc.encrypt(ms)
        dec = Decryptor(sk, LEVEL_ONE, engine="rns")
        assert dec.decrypt(ct) == ms

    def test_crt_decrypt_rns(self, keypair_128, rng):
        from paillier_tpu.core.decrypt import Decryptor
        from paillier_tpu.core.encrypt import Encryptor
        from paillier_tpu.core.keys import LEVEL_ONE
        sk, pk = keypair_128
        ms = [rng.randrange(pk.n) for _ in range(8)]
        enc = Encryptor(pk, LEVEL_ONE, rng=rng, engine="limb")
        ct = enc.encrypt(ms)
        # force the RNS halves on CPU by monkeypatching the gate
        dk = sk.device()
        orig = dk.use_rns
        dk.use_rns = lambda: True
        try:
            dec = Decryptor(sk, LEVEL_ONE, crt=True, engine="rns")
            assert dec.decrypt(ct) == ms
        finally:
            dk.use_rns = orig
            dk.jit_cache.pop(("dec", True, LEVEL_ONE, 4, "rns"), None)

    def test_aggregate_rns(self, keypair_128, rng):
        from paillier_tpu.core import homomorphic as hom
        from paillier_tpu.core.decrypt import Decryptor
        from paillier_tpu.core.encrypt import Encryptor
        from paillier_tpu.core.keys import LEVEL_ONE, Ciphertext
        sk, pk = keypair_128
        vals = [rng.randrange(1000) for _ in range(37)]
        enc = Encryptor(pk, LEVEL_ONE, rng=rng, engine="limb")
        cts = enc.encrypt(vals)
        agg = hom.aggregate(pk, cts, axis=0, engine="rns")
        dec = Decryptor(sk, LEVEL_ONE, engine="limb")
        got = dec.decrypt(Ciphertext(c=agg.c[None], level=LEVEL_ONE))
        assert got == [sum(vals) % pk.n]
        # matches the limb tree bit-exactly
        agg2 = hom.aggregate(pk, cts, axis=0, engine="limb")
        from paillier_tpu.core.keys import decode_batch
        assert decode_batch(agg.c[None]) == decode_batch(agg2.c[None])
