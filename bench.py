"""Benchmark driver.  Prints ONE JSON line per config with the headline
metric: 2048-bit Paillier encryptions/sec/chip (BASELINE target: 100,000).

Runs only on a GPU: any other backend is refused.  Extra configs via argv:

    python bench.py            # headline: 2048-bit batched encryption
    python bench.py all        # every BASELINE config
    python bench.py enc2048 dec2048 agg threshold ddleq enc1024

Timing methodology:
* ``_time_chained`` is the headline number: K kernel iterations chained
  ON DEVICE inside one jit (output feeds the next iteration's input, so
  XLA cannot elide or overlap them), with only a few scalars read back
  per timing rep.  This is sustained kernel throughput.
* ``_time`` (dispatch + jax.block_until_ready) is printed to stderr as
  the single-dispatch number; it includes per-call dispatch overhead but
  not the output transfer.

``chip_smoke.py`` is the correctness gate of the card path; this file
only times it.
"""

import json
import random
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

# Fixed 1024-bit safe primes (p = 2p'+1) for the (3,5)-threshold config so
# the throughput metric measures decryption, not safe-prime luck.
# Generated by paillier_tpu.threshold.safe_prime (seed 0x5AFE2024).
SAFE_P1024 = 0xe422c56ca3c0f2d84f17306861a0b801cb6994fcccff85a797b18be4c14226fa77c2440b48dee0efa7aea10bab5a2a9a1fcd1095a4c221b3825c2dce2facd955c13c370de6c6d15cf850e4b47c52c83698afd26add3ae25953424839b657675ac2b3ec41729024ce3bfaf62c197377cb44a93f532b80d9040096f8c08ff7eb73
SAFE_Q1024 = 0xc35701846e378ba4ace9de4018b37137cc090f0fc2056b78502e38abe63cccb0efba37e3f16a8dcc12b9f655179794558fe416b9b5cf8d558e501a8226a3f4c8ed7d4a01d4038dc1d762f93bff23a33ec2604eb75afc06faefe359c44f20468c252742b742f10f07f075d57371d9b529bcab6a801db5c2e7324c7e905f12f807


def _time(fn, *args, warmup=1, iters=3):
    """Single-dispatch timing: ``iters`` dispatches, then wait for all."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def _time_chained(fn, feed, args, inner=8, reps=2):
    """Sustained kernel throughput: ``inner`` iterations of ``fn`` chained
    on device inside ONE jit — ``feed(out, args)`` rebuilds the arg tuple
    from the previous output, creating a data dependency XLA must honor —
    then a few scalars read back per rep.  Returns seconds per iteration.
    """
    from jax import lax

    args = tuple(jnp.asarray(a) for a in args)

    @jax.jit
    def k_iter(a):
        out = lax.fori_loop(0, inner, lambda i, c: feed(fn(*c), c), a)
        return jax.tree_util.tree_map(lambda x: x.ravel()[:1], out)

    jax.block_until_ready(k_iter(args))          # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(k_iter(args))
    return (time.perf_counter() - t0) / (reps * inner)


def _key(bits, seed=0xBE7C):
    from paillier_tpu.core.keygen import keygen
    rng = random.Random(seed)
    t0 = time.perf_counter()
    sk, pk = keygen(bits, rng)
    print(f"# keygen({bits}) took {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)
    return sk, pk, rng


_KEY_CACHE = {}


def _key_cached(bits):
    if bits not in _KEY_CACHE:
        _KEY_CACHE[bits] = _key(bits)
    return _KEY_CACHE[bits]


def bench_encrypt(bits=2048, batch=4096, window=4, engine="auto",
                  check=64, inner=8):
    from paillier_tpu.core.decrypt import Decryptor
    from paillier_tpu.core.encrypt import Encryptor
    from paillier_tpu.core.keys import LEVEL_ONE, Ciphertext, encode_batch
    sk, pk, rng = _key_cached(bits)
    dk = pk.device()
    enc = Encryptor(pk, LEVEL_ONE, window=window, rng=rng, engine=engine)
    print(f"# engine: {enc.engine}", file=sys.stderr)
    ms = [rng.randrange(pk.n) for _ in range(batch)]
    rs = [rng.randrange(2, pk.n) for _ in range(batch)]
    m = encode_batch(ms, dk.L)
    r = encode_batch(rs, 2 * dk.L)
    # sustained: ciphertext output feeds back as the next randomness
    # (same shape/dtype; any 2L-limb value is a valid ladder input)
    t_e2e = _time(enc._fn, m, r)
    t = _time_chained(enc._fn, lambda out, a: (a[0], out), (m, r),
                      inner=inner)
    print(f"# enc{bits}: sustained {t*1e3:.1f} ms/iter "
          f"({batch/t:,.0f}/s), single-dispatch {t_e2e*1e3:.1f} ms/iter "
          f"({batch/t_e2e:,.0f}/s)", file=sys.stderr)
    # correctness gate: the TIMED kernel's output must decrypt back — a
    # miscompiled ladder cannot emit a number.
    ct = Ciphertext(c=enc._fn(m, r)[:check], level=LEVEL_ONE)
    dec = Decryptor(sk, LEVEL_ONE, crt=True, window=window)
    got = dec.decrypt(ct)
    assert got == ms[:check], (
        f"encrypt bench output FAILED decrypt roundtrip "
        f"({sum(g != w for g, w in zip(got, ms[:check]))}/{check} wrong)")
    print(f"# correctness gate: {check}/{check} decrypt-roundtrip ok",
          file=sys.stderr)
    return batch / t


def bench_encrypt_alt(bits=2048, batch=4096, window=4):
    """Damgard-Jurik alternative encryption (h_s^r, short randomness;
    reference: paillier.go:221-238) via the fixed-base comb kernel."""
    from paillier_tpu.core.encrypt import Encryptor
    from paillier_tpu.core.keys import ALTERNATIVE, LEVEL_ONE, encode_batch
    from paillier_tpu.bigint import montgomery as mont
    sk, pk, rng = _key_cached(bits)
    dk = pk.device()
    enc = Encryptor(pk, LEVEL_ONE, method=ALTERNATIVE, window=window,
                    rng=rng)
    print(f"# engine: {enc.engine}", file=sys.stderr)
    ms = [rng.randrange(pk.n) for _ in range(batch)]
    rs = [rng.randrange(pk.k) for _ in range(batch)]
    m = encode_batch(ms, dk.L)
    nd = mont.n_digits_for_bits(enc._r_bits, window)
    rd = jnp.asarray(np.stack([mont.exp_digits(r, window, nd) for r in rs]))

    def feed(out, a):
        # xor the ciphertext's low bits into the exponent digits (values
        # stay < 2^window) so each iteration depends on the previous
        w = min(nd, out.shape[-1])
        mix = (out[..., :w].astype(jnp.int32) & 1)
        return (a[0], a[1].at[..., :w].set(a[1][..., :w] ^ mix))

    t = _time_chained(enc._fn, feed, (m, rd))
    t_e2e = _time(enc._fn, m, rd)
    print(f"# alt{bits}: sustained {t*1e3:.1f} ms/iter ({batch/t:,.0f}/s),"
          f" single-dispatch {t_e2e*1e3:.1f} ms/iter ({batch/t_e2e:,.0f}/s)",
          file=sys.stderr)
    # correctness gate: spot-check vs the host formula c = (1+mn)*h1^r
    from paillier_tpu.core.keys import decode_batch
    got = decode_batch(enc._fn(m, rd)[:8])
    h1 = dk.hs_int_for_level(1)
    want = [((1 + mi * pk.n) * pow(h1, ri % pk.k, pk.n2)) % pk.n2
            for mi, ri in zip(ms[:8], rs[:8])]
    assert got == want, "alt-encrypt bench output WRONG"
    print("# correctness gate: 8/8 alt ciphertexts ok", file=sys.stderr)
    return batch / t


def bench_encrypt_l2(bits=2048, batch=1024, window=4, check=16):
    """Level-2 (Damgard-Jurik s=2) regular encryption: the wide-spec
    n^3 ladder (k=512 at 2048-bit keys) that underpins DDLEQ and nested
    ciphertexts.  Reference: paillier.go:200-203 (EncryptLevel2 via the
    generic level path)."""
    from paillier_tpu.core.decrypt import Decryptor
    from paillier_tpu.core.encrypt import Encryptor
    from paillier_tpu.core.keys import LEVEL_TWO, Ciphertext, encode_batch
    sk, pk, rng = _key_cached(bits)
    dk = pk.device()
    enc = Encryptor(pk, LEVEL_TWO, window=window, rng=rng)
    print(f"# engine: {enc.engine}", file=sys.stderr)
    ms = [rng.randrange(pk.n2) for _ in range(batch)]
    rs = [rng.randrange(2, pk.n) for _ in range(batch)]
    m = encode_batch(ms, 2 * dk.L)
    r = encode_batch(rs, 3 * dk.L)
    t_e2e = _time(enc._fn, m, r)
    t = _time_chained(enc._fn, lambda out, a: (a[0], out), (m, r),
                      inner=4)
    print(f"# enc{bits}l2: sustained {t*1e3:.1f} ms/iter "
          f"({batch/t:,.0f}/s), single-dispatch {t_e2e*1e3:.1f} ms/iter "
          f"({batch/t_e2e:,.0f}/s)", file=sys.stderr)
    ct = Ciphertext(c=enc._fn(m, r)[:check], level=LEVEL_TWO)
    dec = Decryptor(sk, LEVEL_TWO, window=window)
    got = dec.decrypt(ct)
    assert got == ms[:check], (
        f"level-2 encrypt bench output FAILED decrypt roundtrip "
        f"({sum(g != w for g, w in zip(got, ms[:check]))}/{check} wrong)")
    print(f"# correctness gate: {check}/{check} decrypt-roundtrip ok",
          file=sys.stderr)
    return batch / t


def bench_decrypt_crt(bits=2048, batch=4096, window=4, check=64):
    from paillier_tpu.core.decrypt import Decryptor
    from paillier_tpu.core.encrypt import Encryptor
    from paillier_tpu.core.keys import LEVEL_ONE, decode_batch
    sk, pk, rng = _key_cached(bits)
    enc = Encryptor(pk, LEVEL_ONE, window=window, rng=rng)
    ms = [rng.randrange(pk.n) for _ in range(batch)]
    ct = enc.encrypt(ms)
    dec = Decryptor(sk, LEVEL_ONE, crt=True, window=window)

    def feed(out, a):
        # fold the plaintext back into the ciphertext limbs (xor of the
        # low bit keeps every limb < 2^16)
        return (a[0] ^ (jnp.concatenate([out, out], axis=-1) & 1),)

    t = _time_chained(dec._fn, feed, (ct.c,))
    t_e2e = _time(dec._fn, ct.c)
    print(f"# dec{bits}: sustained {t*1e3:.1f} ms/iter ({batch/t:,.0f}/s),"
          f" single-dispatch {t_e2e*1e3:.1f} ms/iter ({batch/t_e2e:,.0f}/s)",
          file=sys.stderr)
    # correctness gate: the timed kernel's plaintexts must match
    got = decode_batch(dec._fn(ct.c)[:check])
    assert got == ms[:check], (
        f"decrypt bench output WRONG "
        f"({sum(g != w for g, w in zip(got, ms[:check]))}/{check})")
    print(f"# correctness gate: {check}/{check} plaintexts ok",
          file=sys.stderr)
    return batch / t


def bench_aggregate(bits=2048, batch=1 << 20, window=4, chunk=1 << 16):
    """1M-ciphertext homomorphic aggregation (config #3).  Synthesizes the
    big batch by tiling a smaller encrypted batch (aggregation cost does
    not depend on ciphertext values); processed in chunks so device
    memory stays bounded, with a final combine over the chunk partials."""
    from paillier_tpu.core import homomorphic as hom
    from paillier_tpu.core.encrypt import Encryptor
    from paillier_tpu.core.keys import LEVEL_ONE, Ciphertext
    sk, pk, rng = _key_cached(bits)
    enc = Encryptor(pk, LEVEL_ONE, window=window, rng=rng)
    small = enc.encrypt([rng.randrange(pk.n) for _ in range(1024)])
    big = jnp.tile(small.c, (chunk // 1024, 1))

    def agg_all():
        partials = []
        for _ in range(batch // chunk):
            p = hom.aggregate(pk, Ciphertext(c=big, level=LEVEL_ONE),
                              axis=0)
            partials.append(p.c)
        stacked = jnp.stack(partials)
        return hom.aggregate(pk, Ciphertext(c=stacked, level=LEVEL_ONE),
                             axis=0).c

    jax.block_until_ready(agg_all())      # warmup / compile
    t0 = time.perf_counter()
    jax.block_until_ready(agg_all())
    t = time.perf_counter() - t0
    return batch / t


def bench_threshold(bits=2048, batch=4096, l=5, t_=3, window=5,
                    pipeline=4):
    """(3,5)-threshold: batched partial decryption + combination, with
    fixed precomputed safe primes (the metric measures decryption
    throughput, not safe-prime search luck).

    The t per-server ladders run as ONE stacked dispatch
    (partial_decrypt_all) and ``pipeline`` batches flow through a
    2-deep thread pipeline so combine's host-side inverses overlap the
    next batch's device ladders."""
    from concurrent.futures import ThreadPoolExecutor
    from paillier_tpu.core.encrypt import Encryptor
    from paillier_tpu.core.keys import LEVEL_ONE
    from paillier_tpu.threshold.decrypt import combine, partial_decrypt_all
    from paillier_tpu.threshold.keygen import ThresholdKeyGenerator
    rng = random.Random(0x7357)
    t0 = time.perf_counter()
    if bits == 2048:
        p, q = SAFE_P1024, SAFE_Q1024
        keys = ThresholdKeyGenerator(bits, l, t_, rng).generate_from_primes(
            p, (p - 1) // 2, q, (q - 1) // 2)
    else:
        keys = ThresholdKeyGenerator(bits, l, t_, rng).generate()
    print(f"# threshold keygen({bits}) took {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)
    tpk = keys[0].public()
    enc = Encryptor(tpk, LEVEL_ONE, window=window, rng=rng)
    ms = [rng.randrange(tpk.n) for _ in range(batch)]
    ct = enc.encrypt(ms)

    def flow(_i):
        shares = partial_decrypt_all(keys[:t_], ct, window)
        return combine(tpk, shares, window)

    # warm serially (compiles), then time `pipeline` batches 2-deep
    out = flow(0)
    assert out == ms
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as ex:
        for out in ex.map(flow, range(pipeline)):
            assert out == ms
    dt = time.perf_counter() - t0
    return pipeline * batch / dt


def bench_ddleq(bits=2048, proofs=256, secpar=40, window=5, chunk=128):
    """Batched DDLEQ prove+verify throughput (config #5; proofs/sec for
    prove+verify together, measured over ``proofs`` REAL proofs —
    nothing is extrapolated).  Processes the proof batch in chunks of
    ``chunk`` with device memory bounded per chunk."""
    from paillier_tpu.core import homomorphic as hom
    from paillier_tpu.core.encrypt import nested_encrypt
    from paillier_tpu.zk.ddleq import pipeline_prove_verify, prove, verify
    sk, pk, rng = _key_cached(bits)
    ms = [rng.randrange(pk.n) for _ in range(chunk)]
    ct1 = nested_encrypt(pk, ms, rng)
    ct2, a_l, b_l = hom.nested_randomize(pk, ct1, rng)
    # warmup chunk (compiles every ladder — must be serial: the
    # pipelined workers below assume a warm jit cache)
    proof = prove(sk, ct1, ct2, a_l, b_l, secpar, rng, window)
    assert all(verify(pk, ct1, ct2, proof, window))
    # two-deep chunk pipeline: chunk i's host inverses/packing overlap
    # chunk i+1's device ladders
    n_chunks = -(-proofs // chunk)
    jobs = ((ct1, ct2, a_l, b_l, random.Random(0xDD1E0 + i))
            for i in range(n_chunks))
    t0 = time.perf_counter()
    done = 0
    for ok in pipeline_prove_verify(sk, jobs, secpar, window,
                                    verify_pk=pk):
        assert all(ok)
        done += chunk
    dt = time.perf_counter() - t0
    return done / dt


def bench_weak_scaling(bits=2048, base=1024, factor=8, window=4):
    """Single-chip batch weak-scaling of encryption: elements/sec at
    factor*base vs base.  Ideal = 1.0 (throughput independent of batch);
    this is the on-chip half of the BASELINE scaling target — the
    sharded encryption path has no collectives, so per-chip throughput
    at large local batch is the whole multi-host story for config #2."""
    from paillier_tpu.core.encrypt import Encryptor
    from paillier_tpu.core.keys import LEVEL_ONE, encode_batch
    sk, pk, rng = _key_cached(bits)
    dk = pk.device()
    enc = Encryptor(pk, LEVEL_ONE, window=window, rng=rng)
    thr = {}
    for B in (base, base * factor):
        ms = [rng.randrange(pk.n) for _ in range(B)]
        rs = [rng.randrange(2, pk.n) for _ in range(B)]
        m = encode_batch(ms, dk.L)
        r = encode_batch(rs, 2 * dk.L)
        thr[B] = B / _time_chained(enc._fn, lambda out, a: (a[0], out),
                                   (m, r))
        print(f"# weak-scaling B={B}: {thr[B]:,.0f} enc/s", file=sys.stderr)
    return thr[base * factor] / thr[base]


def emit(metric, value, unit):
    d = jax.devices()[0]
    print(json.dumps({
        "metric": metric,
        "value": value,
        "unit": unit,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)


def _run_one(a):
    if a == "enc2048":
        v = bench_encrypt(2048)
        from paillier_tpu.ops.profiling import encryption_roofline
        print(encryption_roofline(2048).report(v), file=sys.stderr)
        emit("2048-bit Paillier encryptions/sec/chip", v, "enc/s")
    elif a == "enc2048alt":
        v = bench_encrypt_alt(2048)
        emit("2048-bit DJ-alternative encryptions/sec/chip", v, "enc/s")
    elif a == "enc1024":
        v = bench_encrypt(1024)
        emit("1024-bit Paillier encryptions/sec/chip", v, "enc/s")
    elif a == "enc4096":
        # SURVEY §5 long-axis top width; wide-spec (k>=640) ladder
        v = bench_encrypt(4096, batch=1024, inner=2)
        emit("4096-bit Paillier encryptions/sec/chip", v, "enc/s")
    elif a == "enc2048l2":
        # level-2 / wide-spec (k=512) datapoint
        v = bench_encrypt_l2(2048)
        emit("2048-bit level-2 (DJ s=2) encryptions/sec/chip", v, "enc/s")
    elif a == "dec2048":
        v = bench_decrypt_crt(2048)
        emit("2048-bit CRT decryptions/sec/chip", v, "dec/s")
    elif a == "agg":
        v = bench_aggregate(2048)
        emit("2048-bit homomorphic adds/sec (1M aggregate)", v, "adds/s")
    elif a == "threshold":
        v = bench_threshold(2048)
        emit("2048-bit (3,5)-threshold decryptions/sec", v, "dec/s")
    elif a == "ddleq":
        v = bench_ddleq(2048)
        emit("2048-bit DDLEQ prove+verify/sec (secpar=40)", v, "proofs/s")
    elif a == "ddleq8k":
        # chunk=128 shares every compiled ladder with the `ddleq` config
        v = bench_ddleq(2048, proofs=8192, chunk=128)
        emit("2048-bit DDLEQ prove+verify/sec (secpar=40, 8k proofs)",
             v, "proofs/s")
    elif a == "ddleq64k":
        # BASELINE config #5 at its stated scale: 64k real proofs
        v = bench_ddleq(2048, proofs=65536, chunk=128)
        emit("2048-bit DDLEQ prove+verify/sec (secpar=40, 64k proofs)",
             v, "proofs/s")
    elif a == "scaling":
        v = bench_weak_scaling(2048)
        emit("encryption batch weak-scaling efficiency (1 chip)", v,
             "ratio")
    else:
        raise ValueError(f"unknown bench {a!r}")


def main():
    from paillier_tpu.config import use_compile_cache
    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {platform!r}")
    use_compile_cache()
    args = sys.argv[1:] or ["enc2048"]
    if "all" in args:
        i = args.index("all")
        args[i:i + 1] = ["enc2048", "enc2048alt", "enc1024",
                         "dec2048", "agg", "threshold", "ddleq"]
    failures = []
    for a in args:
        t0 = time.perf_counter()
        try:
            _run_one(a)
        except Exception:
            # one broken config must not kill the rest of the run
            failures.append(a)
            print(f"# CONFIG {a} FAILED after "
                  f"{time.perf_counter()-t0:.0f}s:", file=sys.stderr)
            traceback.print_exc()
        else:
            print(f"# config {a} done in {time.perf_counter()-t0:.0f}s",
                  file=sys.stderr)
    if failures:
        print(f"# FAILED configs: {failures}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
