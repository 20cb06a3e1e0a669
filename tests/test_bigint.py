"""Property tests for the limb-vector big-integer substrate against the
Python-int oracle (the device replacement for libgmp; SURVEY.md section 7
layer 1)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from paillier_tpu.bigint import host, vpu
from paillier_tpu.bigint import montgomery as mont

R = random.Random(1234)


def _pair(bits, batch, L):
    xs = [R.getrandbits(bits) for _ in range(batch)]
    ys = [R.getrandbits(bits) for _ in range(batch)]
    return (xs, ys,
            jnp.asarray(host.ints_to_limbs(xs, L)),
            jnp.asarray(host.ints_to_limbs(ys, L)))


class TestVpu:
    def test_add_sub_roundtrip(self):
        L = 20
        xs, ys, A, B = _pair(300, 16, L)
        s, carry = vpu.add(A, B)
        s_np, carry_np = np.array(s), np.array(carry)
        got = [v + (int(c) << (16 * L))
               for v, c in zip(host.limbs_to_ints(s_np), carry_np)]
        assert got == [x + y for x, y in zip(xs, ys)]
        d, borrow = vpu.sub(A, B)
        assert host.limbs_to_ints(np.array(d)) == [
            (x - y) % (1 << (16 * L)) for x, y in zip(xs, ys)]
        assert list(np.array(borrow)) == [
            1 if x < y else 0 for x, y in zip(xs, ys)]

    def test_mul_exact(self):
        L = 24
        xs, ys, A, B = _pair(380, 8, L)
        p = vpu.mul(A, B)
        got = host.limbs_to_ints(np.array(p))
        assert got == [x * y for x, y in zip(xs, ys)]

    def test_mul_shared_operand(self):
        L = 12
        xs, _, A, _ = _pair(180, 8, L)
        k = R.getrandbits(100)
        Kl = jnp.asarray(host.int_to_limbs(k, L))
        p = vpu.mul(A, Kl)
        assert host.limbs_to_ints(np.array(p)) == [x * k for x in xs]

    def test_mul_low(self):
        L = 16
        xs, ys, A, B = _pair(250, 8, L)
        p = vpu.mul_low(A, B, L)
        got = host.limbs_to_ints(np.array(p))
        assert got == [(x * y) % (1 << (16 * L)) for x, y in zip(xs, ys)]

    def test_geq_cond_sub(self):
        L = 8
        xs, ys, A, B = _pair(120, 32, L)
        g = vpu.geq(A, B)
        assert [bool(v) for v in g] == [x >= y for x, y in zip(xs, ys)]
        cs = vpu.cond_sub(A, B)
        assert host.limbs_to_ints(np.array(cs)) == [
            x - y if x >= y else x for x, y in zip(xs, ys)]

    def test_edge_all_ones_carry_chain(self):
        # 0xFFFF.. + 1 must ripple through the whole number
        L = 10
        x = (1 << (16 * L)) - 1
        A = jnp.asarray(host.ints_to_limbs([x], L))
        one = jnp.asarray(host.ints_to_limbs([1], L))
        s, carry = vpu.add(A, one)
        assert host.limbs_to_int(np.array(s[0])) == 0
        assert int(carry[0]) == 1


class TestMontgomery:
    @pytest.mark.parametrize("nbits", [64, 128, 257])
    def test_modmul(self, nbits):
        n = host.random_prime(nbits // 2 + 1) * host.random_prime(nbits // 2)
        ctx = mont.make_mont_ctx(n)
        L = ctx.n_limbs
        xs = [R.randrange(n) for _ in range(8)]
        ys = [R.randrange(n) for _ in range(8)]
        X = jnp.asarray(host.ints_to_limbs(xs, L))
        Y = jnp.asarray(host.ints_to_limbs(ys, L))
        got = host.limbs_to_ints(np.array(mont.modmul(ctx, X, Y)))
        assert got == [(x * y) % n for x, y in zip(xs, ys)]

    def test_pow_shared_and_per_element(self):
        n = host.random_prime(80) * host.random_prime(80)
        ctx = mont.make_mont_ctx(n)
        L = ctx.n_limbs
        xs = [R.randrange(n) for _ in range(6)]
        X = jnp.asarray(host.ints_to_limbs(xs, L))
        e = R.getrandbits(120)
        got = host.limbs_to_ints(np.array(mont.mont_pow(ctx, X, e)))
        assert got == [pow(x, e, n) for x in xs]

        es = [R.getrandbits(90) for _ in range(6)]
        nd = mont.n_digits_for_bits(90, 4)
        digs = jnp.asarray(np.stack(
            [mont.exp_digits(ei, 4, nd) for ei in es]))
        got = host.limbs_to_ints(
            np.array(mont.mont_pow_digits(ctx, X, digs, 4)))
        assert got == [pow(x, ei, n) for x, ei in zip(xs, es)]

    def test_pow_edge_exponents(self):
        n = host.random_prime(64) * host.random_prime(64)
        ctx = mont.make_mont_ctx(n)
        L = ctx.n_limbs
        xs = [R.randrange(n) for _ in range(4)]
        X = jnp.asarray(host.ints_to_limbs(xs, L))
        assert host.limbs_to_ints(np.array(mont.mont_pow(ctx, X, 0))) == [1] * 4
        assert host.limbs_to_ints(np.array(mont.mont_pow(ctx, X, 1))) == xs
        got = host.limbs_to_ints(np.array(mont.mont_pow(ctx, X, 2)))
        assert got == [(x * x) % n for x in xs]

    def test_fixed_base_pow(self):
        n = host.random_prime(70) * host.random_prime(70)
        ctx = mont.make_mont_ctx(n)
        L = ctx.n_limbs
        g = R.randrange(n)
        G = jnp.asarray(host.int_to_limbs(g, L))
        es = [R.getrandbits(64) for _ in range(5)]
        nd = mont.n_digits_for_bits(64, 4)
        digs = jnp.asarray(np.stack(
            [mont.exp_digits(ei, 4, nd) for ei in es]))
        got = host.limbs_to_ints(
            np.array(mont.mont_pow_fixed_base(ctx, G, digs, 4)))
        assert got == [pow(g, ei, n) for ei in es]

    def test_mod_wide(self):
        n = host.random_prime(96) * host.random_prime(96)
        ctx = mont.make_mont_ctx(n)
        L = ctx.n_limbs
        xs = [R.getrandbits(16 * 2 * L - 4) % (n * n) for _ in range(8)]
        X = jnp.asarray(host.ints_to_limbs(xs, 2 * L))
        got = host.limbs_to_ints(np.array(mont.mod_wide(ctx, X)))
        assert got == [x % n for x in xs]

    def test_limbs_to_digits(self):
        L = 6
        xs = [R.getrandbits(90) for _ in range(4)]
        X = jnp.asarray(host.ints_to_limbs(xs, L))
        d = mont.limbs_to_digits(X, 4)
        for i, x in enumerate(xs):
            val = 0
            for dig in np.array(d[i]):
                val = (val << 4) | int(dig)
            assert val == x

    def test_exact_div(self):
        n = host.random_prime(100)
        L = host.limbs_for_bits(200)
        qs = [R.getrandbits(95) for _ in range(8)]
        xs = [q * n for q in qs]
        X = jnp.asarray(host.ints_to_limbs(xs, L))
        ninv = jnp.asarray(host.int_to_limbs(host.hensel_inverse(n, L), L))
        got = host.limbs_to_ints(np.array(mont.exact_div(X, ninv, L)))
        assert got == qs
