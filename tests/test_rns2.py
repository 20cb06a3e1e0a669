"""RNS-v2 engine tests: parity of the int8 Cox-Rower math against Python
big-int arithmetic.  The ladders are the same XLA programs on every
backend, so the CPU runs exactly the math the GPU runs."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from paillier_tpu.bigint import host
from paillier_tpu.bigint import montgomery as mont
from paillier_tpu.bigint.rns2 import Rns2Engine, rns2_pow


@pytest.fixture(scope="module")
def eng256():
    random.seed(0x5EED)
    n = random.getrandbits(256) | (1 << 255) | 1
    return n, Rns2Engine(n)


def test_encode_decode_roundtrip(eng256):
    n, eng = eng256
    xs = [random.randrange(n) for _ in range(16)] + [0, 1, n - 1]
    assert eng.decode(eng.encode(xs)) == xs


def test_mont_mul_and_mul(eng256):
    n, eng = eng256
    xs = [random.randrange(n) for _ in range(16)]
    ys = [random.randrange(n) for _ in range(16)]
    rx, ry = eng.encode(xs), eng.encode(ys)
    minv = pow(eng.spec.M, -1, n)
    assert eng.decode(eng.mont_mul(rx, ry)) == [
        (x * y * minv) % n for x, y in zip(xs, ys)]
    assert eng.decode(eng.mul(rx, ry)) == [
        (x * y) % n for x, y in zip(xs, ys)]


@pytest.mark.parametrize("window", [3, 4])
def test_pow_shared_exponent(eng256, window):
    n, eng = eng256
    xs = [random.randrange(n) for _ in range(8)]
    e = random.getrandbits(200)
    nd = mont.n_digits_for_bits(e.bit_length(), window)
    digits = jnp.asarray(mont.exp_digits(e, window, nd))
    out = rns2_pow(eng.ctx, eng.encode(xs), digits, window)
    assert eng.decode(out) == [pow(x, e, n) for x in xs]


def test_pow_per_element_exponents(eng256):
    n, eng = eng256
    window = 4
    xs = [random.randrange(n) for _ in range(8)]
    es = [random.getrandbits(128) for _ in range(8)]
    nd = mont.n_digits_for_bits(128, window)
    digits = jnp.asarray(
        np.stack([mont.exp_digits(e, window, nd) for e in es]))
    out = rns2_pow(eng.ctx, eng.encode(xs), digits, window)
    assert eng.decode(out) == [pow(x, e, n) for x, e in zip(xs, es)]


def test_limb_conversion_roundtrip(eng256):
    n, eng = eng256
    xs = [random.randrange(n) for _ in range(8)] + [0, 1, n - 1]
    L = host.limbs_for_bits(256)
    xl = jnp.asarray(host.ints_to_limbs(xs, L))
    r = eng.from_limbs(xl)
    assert eng.decode(r) == xs
    back = eng.to_limbs(r)
    assert host.limbs_to_ints(np.asarray(back)) == xs


def test_pow_result_exact_in_limb_domain(eng256):
    """to_limbs of a pow output (< lambda*N) is an exact representative."""
    n, eng = eng256
    window = 4
    xs = [random.randrange(n) for _ in range(8)]
    e = random.getrandbits(256)
    nd = mont.n_digits_for_bits(e.bit_length(), window)
    out = rns2_pow(eng.ctx, eng.encode(xs),
                       jnp.asarray(mont.exp_digits(e, window, nd)), window)
    vals = host.limbs_to_ints(np.asarray(eng.to_limbs(out)))
    assert [v % n for v in vals] == [pow(x, e, n) for x in xs]


def test_spec_invariants(eng256):
    n, eng = eng256
    s = eng.spec
    lam = s.lam
    assert s.M >= lam * lam * n            # first-base range closure
    assert s.M2 >= 8 * lam * n             # cox fraction margin
    assert len(set(s.all_m)) == len(s.all_m)
    assert all(m < (1 << 14) for m in s.all_m)
    assert s.k % 64 == 0


def test_engine_dispatch_unified_api():
    from paillier_tpu.bigint.engine import make_engine
    random.seed(3)
    n = random.getrandbits(192) | (1 << 191) | 1
    for kind in ("rns2", "rns"):
        eng = make_engine(n, host.limbs_for_bits(192), kind)
        xs = [random.randrange(n) for _ in range(4)]
        L = host.limbs_for_bits(192)
        xl = jnp.asarray(host.ints_to_limbs(xs, L))
        e = random.getrandbits(64)
        nd = mont.n_digits_for_bits(64, 4)
        digits = jnp.asarray(mont.exp_digits(e, 4, nd))
        out = eng.pow(eng.from_limbs(xl), digits, 4)
        vals = host.limbs_to_ints(np.asarray(eng.to_limbs(out)))
        assert [v % n for v in vals] == [pow(x, e, n) for x in xs], kind


# ---------------------------------------------------------------------------
# The ladder entry points at edge exponents (1, 2, 3: a single digit, the
# table's first entries, no squaring-only steps)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e", [1, 2, 3])
def test_rns2_pow_edge_exponents(eng256, e):
    n, eng = eng256
    xs = [random.randrange(n) for _ in range(4)]
    shared = jnp.asarray(mont.exp_digits(e, 4, 1))
    out = rns2_pow(eng.ctx, eng.encode(xs), shared, 4)
    assert eng.decode(out) == [pow(x, e, n) for x in xs]
    # per-element digits: each element gets a different small exponent
    es = [e, 1, 2, 3]
    per = jnp.asarray(np.stack([mont.exp_digits(v, 4, 1) for v in es]))
    out = rns2_pow(eng.ctx, eng.encode(xs), per, 4)
    assert eng.decode(out) == [pow(x, v, n) for x, v in zip(xs, es)]


@pytest.mark.parametrize("e", [1, 2, 3])
def test_rns2_pow_sliding_edge_exponents(eng256, e):
    from paillier_tpu.bigint.rns2 import (rns2_pow_sliding,
                                          sliding_window_schedule)
    n, eng = eng256
    xs = [random.randrange(n) for _ in range(4)]
    sched = jnp.asarray(sliding_window_schedule(e, 5))
    out = rns2_pow_sliding(eng.ctx, eng.encode(xs), sched, 5)
    assert eng.decode(out) == [pow(x, e, n) for x in xs]


@pytest.mark.parametrize("e", [1, 2, 3])
def test_rns2_pow_fixed_base_edge_exponents(eng256, e):
    from paillier_tpu.bigint.rns2 import (build_fixed_base_table,
                                          rns2_pow_fixed_base)
    n, eng = eng256
    base = random.randrange(2, n)
    nd = mont.n_digits_for_bits(60, 4)
    table = build_fixed_base_table(eng, base, nd, 4)
    es = [e, 0, random.getrandbits(60), (1 << 60) - 1]
    digits = jnp.asarray(np.stack([mont.exp_digits(v, 4, nd) for v in es]))
    out = rns2_pow_fixed_base(eng.ctx, table, digits, 4)
    assert eng.decode(out) == [pow(base, v, n) for v in es]


def test_sliding_fused_final_multiplicand(eng256):
    """The fin operand rides the ladder's exit multiply: x^e * fin mod n
    (encryption's G^m fusion) — plain and with the -2 skip sentinel,
    bit-exact vs Python pow."""
    from paillier_tpu.bigint.rns2 import (rns2_pow_sliding,
                                          sliding_window_schedule)
    n, eng = eng256
    xs = [random.randrange(n) for _ in range(8)]
    fs = [random.randrange(n) for _ in range(8)]
    fin = eng.encode(fs)
    e = random.getrandbits(150) | (1 << 149)
    want = [pow(x, e, n) * f % n for x, f in zip(xs, fs)]
    sched = jnp.asarray(sliding_window_schedule(e, 5))
    out = rns2_pow_sliding(eng.ctx, eng.encode(xs), sched, 5, fin=fin)
    assert eng.decode(out) == want
    # -2 pad sentinel: appended skip steps must not change the result
    sched_pad = jnp.concatenate([sched, jnp.full((3,), -2, jnp.int32)])
    out = rns2_pow_sliding(eng.ctx, eng.encode(xs), sched_pad, 5, fin=fin)
    assert eng.decode(out) == want


def test_one_plus_mul_residues(eng256):
    """rns2_one_plus_mul: (1 + x*c) residues, valid while 1 + x*c < M
    (encryption uses it with x = m < sqrt(N), c = sqrt(N))."""
    from paillier_tpu.bigint.rns2 import rns2_one_plus_mul
    n, eng = eng256
    c = random.getrandbits(128)
    crow = jnp.asarray(np.asarray(
        [c % m for m in eng.spec.b1 + eng.spec.b2], dtype=np.int32))
    xs = [random.getrandbits(120) for _ in range(8)]
    out = rns2_one_plus_mul(eng.ctx, eng.encode(xs), crow)
    assert eng.decode(out) == [(1 + x * c) % n for x in xs]


def test_encrypt_fused_gm_parity(eng256):
    """Fused-G^m encryption == unfused RNS kernel == host formula."""
    import dataclasses
    from paillier_tpu.core.encrypt import (encrypt_with_r_rns_fused_kernel,
                                           encrypt_with_r_rns_kernel)
    from paillier_tpu.core.keygen import keygen
    from paillier_tpu.core.keys import LEVEL_ONE, decode_batch, encode_batch
    rng = random.Random(0xF05ED)
    sk, pk = keygen(128, rng)
    dk = pk.device()
    eng = dk.rns(LEVEL_ONE)
    ms = [rng.randrange(pk.n) for _ in range(4)] + [0, pk.n - 1]
    rs = [rng.randrange(2, pk.n) for _ in range(len(ms))]
    m = encode_batch(ms, dk.L)
    r = encode_batch(rs, 2 * dk.L)
    nrow = jnp.asarray(np.asarray(
        [pk.n % mi for mi in eng.spec.b1 + eng.spec.b2], dtype=np.int32))
    got = decode_batch(encrypt_with_r_rns_fused_kernel(
        dk, eng, nrow, m, r, pk.n))
    ref = decode_batch(encrypt_with_r_rns_kernel(
        dk, eng, m, r, LEVEL_ONE, pk.n))
    want = [(1 + mi * pk.n) * pow(ri, pk.n, pk.n2) % pk.n2
            for mi, ri in zip(ms, rs)]
    assert got == want
    assert ref == want


def test_sliding_schedule_and_jnp_parity(eng256):
    from paillier_tpu.bigint.rns2 import (rns2_pow_sliding,
                                          sliding_window_schedule)
    n, eng = eng256
    xs = [random.randrange(n) for _ in range(8)]
    for e in (1, 5, 64, random.getrandbits(200)):
        for w in (4, 6):
            sched = jnp.asarray(sliding_window_schedule(e, w))
            out = rns2_pow_sliding(eng.ctx, eng.encode(xs), sched, w)
            assert eng.decode(out) == [pow(x, e, n) for x in xs], (e, w)


@pytest.mark.slow
def test_wide_spec_k512_overflow_guard():
    """k >= 512 specs route the shift-combines through an extra
    reduction (the int32 overflow guard in rns2_mont_mul_pair): parity
    on a ~6500-bit modulus whose spec lands at k = 512."""
    rng = random.Random(0x51DE)
    n = rng.getrandbits(6500) | (1 << 6499) | 1
    eng = Rns2Engine(n)
    assert eng.spec.k >= 512, eng.spec.k
    xs = [rng.randrange(n) for _ in range(2)]
    rx = eng.encode(xs)
    assert eng.decode(eng.mul(rx, rx)) == [(x * x) % n for x in xs]
    e = 0x10001
    out = eng.pow_shared(rx, e, window=4)
    assert eng.decode(out) == [pow(x, e, n) for x in xs]


@pytest.mark.parametrize("mod_bits", [4096, 6144, 8192])
def test_cox_alpha_bound_holds_in_any_order(mod_bits):
    """The cox alpha f32 error bound (rns2._cox_sum_error) dominates the
    error of the worst digits summed in several orders, and the spec's
    COX_EPS margin holds at the widths the main path builds (k=320: 2048-
    bit keys; 512: level 2; 640: 4096-bit keys)."""
    from fractions import Fraction

    from paillier_tpu.bigint.rns2 import COX_EPS, Rns2Spec, _cox_sum_error
    spec = Rns2Spec((1 << (mod_bits - 1)) | 1)
    b2 = np.asarray(spec.b2, dtype=np.int64)
    err = _cox_sum_error(spec.b2)
    drift = spec.k * 256 * spec.N / spec.M2
    assert drift + err < COX_EPS and 0.125 + drift + err + COX_EPS < 1
    rng = np.random.default_rng(mod_bits)
    inv = (1.0 / b2.astype(np.float64)).astype(np.float32)
    for trial in range(4):
        sg = rng.integers(-(1 << 14) + 1, 1 << 14, b2.size)
        exact = sum(Fraction(int(s), int(m)) for s, m in zip(sg, b2))
        terms = sg.astype(np.float32) * inv
        for order in (np.arange(b2.size), np.argsort(terms),
                      np.argsort(-np.abs(terms))):
            acc = np.float32(0)
            for t in terms[order]:
                acc = np.float32(acc + t)
            assert abs(float(acc + np.float32(COX_EPS)) - COX_EPS
                       - float(exact)) < err
        assert abs(float(np.sum(terms)) - float(exact)) < err
