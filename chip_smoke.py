"""Smoke check of the library's main path on a GPU.

Drives the user entry points (keygen, Encryptor, Decryptor, homomorphic,
threshold partial_decrypt_all/combine, DDLEQ prove/verify) at 2048-bit
keys and batch 4096 on one card, and checks every phase bit-exactly
against the plain reference: Python ``pow`` on host ints, or the
plaintexts themselves.  Tolerance is zero: this is integer arithmetic.

Each phase prints one line with its first-call seconds (compilation
included, i.e. set-up), its second-call seconds (ending in
``jax.block_until_ready``) and the device's ``peak_bytes_in_use``.  A
failing phase raises and the script exits non-zero.  The last line of
standard output is the JSON verdict.

    python chip_smoke.py           # main path on one card
    python chip_smoke.py --four    # sharded aggregate, distributed combine
                                   # and sharded DDLEQ on a 4-card mesh,
                                   # each compared with the 1-card result

Any backend other than ``gpu`` is refused (exit code 2, nothing printed
on standard output).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import random
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

# Fixed 1024-bit safe primes (p = 2p'+1), as in bench.py's threshold
# config, so threshold key generation costs no safe-prime search.
from bench import SAFE_P1024, SAFE_Q1024


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Widths and batch sizes of one smoke run (defaults: the real ones)."""

    bits: int = 2048            # key size of the main phases
    batch: int = 4096           # ciphertexts per batch
    agg: int = 65536            # ciphertexts in the aggregate
    check: int = 64             # ciphertexts checked against host pow
    proofs: int = 128           # DDLEQ proofs (one chunk)
    secpar: int = 40            # DDLEQ instances per proof
    wide_bits: int = 4096       # key size of the widest roundtrip
    wide_batch: int = 64        # batch of the widest phases


def _peak_bytes() -> int | None:
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def phase(name: str, run, check):
    """Run ``run`` twice (compile + warm, then steady), check the second
    output, print one timing line, return that output."""
    t0 = time.perf_counter()
    jax.block_until_ready(run())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(run())
    second = time.perf_counter() - t0
    check(out)
    print(f"phase {name}: ok first_call_s={first:.3f} "
          f"second_call_s={second:.3f} peak_bytes_in_use={_peak_bytes()}",
          flush=True)
    return out


def host_encrypt(pk, m: int, r: int) -> int:
    """Reference regular encryption (1 + m*n) * r^n mod n^2."""
    return (1 + m * pk.n) * pow(r, pk.n, pk.n2) % pk.n2


def host_product(values, mod: int) -> int:
    """Reference homomorphic sum: the product of ``values`` mod ``mod``."""
    prod = 1
    for v in values:
        prod = prod * v % mod
    return prod


def threshold_keys(bits: int, rng: random.Random):
    """(3,5)-threshold keys; at 2048 bits from the fixed safe primes."""
    from paillier_tpu.threshold.keygen import (ThresholdKeyGenerator,
                                               generate_threshold_keys)
    if bits != 2048:
        return generate_threshold_keys(bits, 5, 3, rng)
    p, q = SAFE_P1024, SAFE_Q1024
    return ThresholdKeyGenerator(bits, 5, 3, rng).generate_from_primes(
        p, (p - 1) // 2, q, (q - 1) // 2)


_HLO_COMP = re.compile(r"^(?:ENTRY )?%([\w.\-]+) .*\{$")
_HLO_INSTR = re.compile(r"^\s+(?:ROOT )?%([\w.\-]+) = (.*)$")
_HLO_GEMM = re.compile(r" (dot|custom-call)\(([^)]*)\)")
_HLO_OPERAND = re.compile(r"(?:([a-z]\w*)\[\S*\s)?%([\w.\-]+)")
_DTYPE = re.compile(r"^\(?([a-z]\w*)\[")


def _hlo_gemms(hlo: str):
    """Yield (line, result dtype, operand dtypes, calling fusion's kind)
    for every dot and cuBLAS GEMM call of an optimized HLO module.

    Operands may print by name only; their dtypes are then looked up among
    the earlier instructions of the same computation.  A dot's computation
    is the body of the fusion that calls it (a Triton GEMM is kCustom)."""
    called_by = {comp: kind for kind, comp in
                 re.findall(r"kind=(k\w+), calls=%([\w.\-]+)", hlo)}
    comp, dtypes = None, {}
    for ln in hlo.splitlines():
        if m := _HLO_COMP.match(ln):
            comp, dtypes = m.group(1), {}
        elif m := _HLO_INSTR.match(ln):
            name, rest = m.groups()
            dt = _DTYPE.match(rest)
            dtypes[name] = dt.group(1) if dt else "?"
            g = _HLO_GEMM.search(rest)
            if g and (g.group(1) == "dot" or "__cublas" in rest):
                ops = [inline or dtypes.get(op, "?") for inline, op
                       in _HLO_OPERAND.findall(g.group(2))]
                yield ln.strip(), dtypes[name], ops, called_by.get(comp)


def check_int8_gemms(hlo: str, where: str) -> int:
    """Every GEMM XLA emitted (cuBLAS call or Triton fusion) is s8 x s8 ->
    s32, none sits in an elementwise fusion, and there is at least one: an
    int8 dot upcast to an f32 GEMM would lose exactness above 2^24 at
    k=640.  Returns the number of GEMMs."""
    gemms = list(_hlo_gemms(hlo))
    bad = [ln for ln, out, ops, kind in gemms
           if out != "s32" or ops[:2] != ["s8", "s8"]
           or kind in ("kLoop", "kInput", "kOutput")]
    if not gemms or bad:
        raise AssertionError(
            f"{where}: expected s8 x s8 -> s32 GEMMs, got "
            f"{(bad or ['no GEMM'])[:4]}")
    return len(gemms)


def int8_dot_phase(sizes: Sizes) -> None:
    """Compile the base-extension dot alone at the widths the main path
    uses (k=320: 2048-bit level 1; 512: level 2; 640: 4096-bit keys) and
    check its optimized HLO and its output against numpy int64."""
    from paillier_tpu.bigint.rns2 import _dot_i8
    rng = np.random.default_rng(7)
    for k in (320, 512, 640):
        pk = -(-k // 128) * 128
        lhs = rng.integers(-128, 128, (sizes.batch, 2 * k), dtype=np.int8)
        rhs = rng.integers(-128, 128, (2 * k, 2 * pk), dtype=np.int8)
        compiled = jax.jit(_dot_i8).lower(lhs, rhs).compile()
        n = check_int8_gemms(compiled.as_text(), f"_dot_i8 k={k}")
        got = np.asarray(compiled(lhs, rhs))
        want = lhs.astype(np.int64) @ rhs.astype(np.int64)
        assert got.dtype == np.int32 and np.array_equal(got, want), k
        print(f"int8 dot k={k}: {n} s8 GEMM op(s), exact vs int64",
              flush=True)


def main_path(sizes: Sizes, rng: random.Random) -> None:
    from paillier_tpu.core import homomorphic as hom
    from paillier_tpu.core.decrypt import Decryptor
    from paillier_tpu.core.encrypt import Encryptor, nested_encrypt
    from paillier_tpu.core.keygen import keygen
    from paillier_tpu.core.keys import (ALTERNATIVE, LEVEL_ONE, LEVEL_TWO,
                                        Ciphertext, decode_batch,
                                        encode_batch)
    from paillier_tpu.ops import random as prand
    from paillier_tpu.threshold.decrypt import combine, partial_decrypt_all
    from paillier_tpu.zk.ddleq import prove, verify

    B, C = sizes.batch, sizes.check
    sk, pk = keygen(sizes.bits, rng, device_primes=False)
    dk = pk.device()
    ms = [rng.randrange(pk.n) for _ in range(B)]
    rs = prand.random_units(pk.n, B, rng)

    # 2. regular encryption (sliding ladder, G^m fused) + CRT decryption
    enc = Encryptor(pk, LEVEL_ONE, rng=rng)
    assert enc.engine == "rns", enc.engine
    ct = phase("encrypt", lambda: enc.encrypt(ms, rs).c,
               lambda c: _eq(decode_batch(c[:C]),
                             [host_encrypt(pk, m, r)
                              for m, r in zip(ms[:C], rs[:C])], "encrypt"))
    step = enc._fn.lower(encode_batch(ms, dk.L),
                         encode_batch(rs, 2 * dk.L)).compile()
    print(f"encrypt step B={B}: {step.memory_analysis()}", flush=True)
    print(f"encrypt step: {check_int8_gemms(step.as_text(), 'encrypt')} "
          "s8 GEMM op(s)", flush=True)
    dec = Decryptor(sk, LEVEL_ONE, crt=True)
    cto = Ciphertext(c=ct, level=LEVEL_ONE)
    phase("decrypt_crt", lambda: dec.decrypt(cto),
          lambda out: _eq(out, ms, "decrypt_crt"))

    # 3. alternative encryption (fixed-base comb)
    enca = Encryptor(pk, LEVEL_ONE, method=ALTERNATIVE, rng=rng)
    ras = [rng.randrange(pk.k) for _ in range(B)]
    h1 = dk.hs_int_for_level(1)
    phase("encrypt_alt", lambda: enca.encrypt(ms, ras).c,
          lambda c: _eq(decode_batch(c[:C]),
                        [(1 + m * pk.n) * pow(h1, r, pk.n2) % pk.n2
                         for m, r in zip(ms[:C], ras[:C])], "encrypt_alt"))

    # 4. homomorphic aggregate over sizes.agg ciphertexts (the batch tiled)
    # and const_mult
    reps = sizes.agg // B
    big = jnp.tile(ct, (reps, 1))
    prod = host_product(decode_batch(ct), pk.n2)
    phase("aggregate",
          lambda: hom.aggregate(pk, Ciphertext(c=big, level=LEVEL_ONE),
                                axis=0).c,
          lambda c: _eq(decode_batch(c[None]), [pow(prod, reps, pk.n2)],
                        "aggregate"))
    kc = rng.randrange(pk.n)
    cm = phase("const_mult", lambda: hom.const_mult(pk, cto, kc).c,
               lambda c: _eq(decode_batch(c[:C]),
                             [pow(v, kc, pk.n2)
                              for v in decode_batch(ct[:C])], "const_mult"))
    _eq(dec.decrypt(Ciphertext(c=cm, level=LEVEL_ONE)),
        [kc * m % pk.n for m in ms], "const_mult decrypt")

    # 5. (3,5)-threshold: encrypt, stacked partial decryptions, combine
    trng = random.Random(0x7357)
    keys = threshold_keys(sizes.bits, trng)
    tpk = keys[0].public()
    tms = [trng.randrange(tpk.n) for _ in range(B)]
    tenc = Encryptor(tpk, LEVEL_ONE, rng=trng)

    def threshold():
        tct = tenc.encrypt(tms)
        return combine(tpk, partial_decrypt_all(keys[:3], tct))

    phase("threshold", threshold, lambda out: _eq(out, tms, "threshold"))

    # 6. DDLEQ: nested encryption, re-randomization, prove + verify
    P = sizes.proofs
    dms = [rng.randrange(pk.n) for _ in range(P)]

    def ddleq():
        r = random.Random(0xDD1E)
        ct1 = nested_encrypt(pk, dms, r)
        ct2, a_l, b_l = hom.nested_randomize(pk, ct1, r)
        proof = prove(sk, ct1, ct2, a_l, b_l, sizes.secpar, r)
        return verify(pk, ct1, ct2, proof), verify(pk, ct2, ct1, proof)

    def ddleq_ok(out):
        ok, swapped = out
        assert len(ok) == P and all(ok), f"ddleq: {sum(ok)}/{P} verified"
        assert not any(swapped), "ddleq: swapped ciphertexts verified"

    phase("ddleq", ddleq, ddleq_ok)

    # 7. widest specs: per-element rns2_pow at level 2 (n^3), and a
    # sizes.wide_bits-bit key roundtrip (n^2)
    W = sizes.wide_batch
    from paillier_tpu.bigint import montgomery as mont
    eng2 = dk.rns(LEVEL_TWO)
    xs = [rng.randrange(2, pk.n3) for _ in range(W)]
    es = [rng.getrandbits(sizes.bits) for _ in range(W)]
    nd = mont.n_digits_for_bits(sizes.bits, 4)
    digs = jnp.asarray(np.stack([mont.exp_digits(e, 4, nd) for e in es]))
    phase(f"rns2_pow_level2_k{eng2.spec.k}",
          lambda: eng2.pow(eng2.encode(xs), digs, 4),
          lambda out: _eq(eng2.decode(out),
                          [pow(x, e, pk.n3) for x, e in zip(xs, es)],
                          "rns2_pow level 2"))

    wsk, wpk = keygen(sizes.wide_bits, rng, device_primes=False)
    wms = [rng.randrange(wpk.n) for _ in range(W)]
    wrs = prand.random_units(wpk.n, W, rng)
    wenc = Encryptor(wpk, LEVEL_ONE, rng=rng)
    wdec = Decryptor(wsk, LEVEL_ONE, crt=True)
    assert wenc.engine == "rns"
    k_wide = wpk.device().rns(LEVEL_ONE).spec.k

    def wide():
        c = wenc.encrypt(wms, wrs)
        return c.c, wdec.decrypt(c)

    def wide_ok(out):
        c, plain = out
        n16 = min(16, W)
        _eq(decode_batch(c[:n16]), [host_encrypt(wpk, m, r) for m, r
                                    in zip(wms[:n16], wrs[:n16])], "wide")
        _eq(plain, wms, "wide decrypt")

    phase(f"roundtrip_{sizes.wide_bits}_k{k_wide}", wide, wide_ok)

    # 8. device SHA-256 against hashlib
    from paillier_tpu.ops.sha256 import digest_to_ints, sha256_bytes
    msgs = [rng.randbytes(rng.randrange(0, 200)) for _ in range(64)]
    data = np.zeros((len(msgs), 200), np.uint32)
    for i, m in enumerate(msgs):
        data[i, :len(m)] = np.frombuffer(m, np.uint8)
    lens = jnp.asarray([len(m) for m in msgs], jnp.int32)
    phase("sha256", lambda: sha256_bytes(jnp.asarray(data), lens),
          lambda d: _eq(digest_to_ints(d),
                        [int.from_bytes(hashlib.sha256(m).digest(), "big")
                         for m in msgs], "sha256"))


def four_cards(sizes: Sizes, rng: random.Random) -> None:
    """The three sharded paths on a 4-card mesh, each compared bit-exactly
    with the same call on a 1-card mesh of this process."""
    from jax.sharding import Mesh

    from paillier_tpu.core.encrypt import Encryptor
    from paillier_tpu.core.keygen import keygen
    from paillier_tpu.core.keys import LEVEL_ONE, Ciphertext, decode_batch
    from paillier_tpu.parallel.collective import (distributed_combine,
                                                  sharded_aggregate)
    from paillier_tpu.parallel.mesh import (BATCH_AXIS, SERVER_AXIS,
                                            make_mesh, shard_batch)
    from paillier_tpu.threshold.decrypt import (compute_lambda,
                                                lagrange_powers,
                                                partial_decrypt_all)

    devs = jax.devices()
    B = sizes.batch
    sk, pk = keygen(sizes.bits, rng, device_primes=False)
    ms = [rng.randrange(pk.n) for _ in range(B)]
    ct = Encryptor(pk, LEVEL_ONE, rng=rng).encrypt(ms).c

    # sharded_aggregate: batch axis over the cards
    reps = sizes.agg // B
    big = jnp.tile(ct, (reps, 1))
    prod = host_product(decode_batch(ct), pk.n2)
    want = [pow(prod, reps, pk.n2)]
    outs = {}
    for n in (1, 4):
        mesh = make_mesh(n)
        cts = Ciphertext(c=shard_batch(big, mesh), level=LEVEL_ONE)
        outs[n] = phase(f"sharded_aggregate_{n}card",
                        lambda: sharded_aggregate(pk, cts, mesh).c,
                        lambda c: _eq(decode_batch(c[None]), want,
                                      "sharded_aggregate"))
    assert np.array_equal(np.asarray(outs[1]), np.asarray(outs[4]))

    # distributed_combine: 4 of the 5 servers, (servers, batch) mesh
    trng = random.Random(0x7357)
    keys = threshold_keys(sizes.bits, trng)
    tpk = keys[0].public()
    tms = [trng.randrange(tpk.n) for _ in range(B)]
    tct = Encryptor(tpk, LEVEL_ONE, rng=trng).encrypt(tms)
    srv = keys[:4]
    ids = [k.id for k in srv]
    lam2s = [2 * compute_lambda(tpk, k.id, ids) for k in srv]
    signs = [1 if l2 >= 0 else -1 for l2 in lam2s]
    pds = jnp.stack([s.c for s in partial_decrypt_all(srv, tct)])
    powed = lagrange_powers(tpk, pds, [abs(l2) for l2 in lam2s])
    outs = {}
    for rows, cols in ((1, 1), (2, 2)):
        mesh = Mesh(np.array(devs[:rows * cols]).reshape(rows, cols),
                    (SERVER_AXIS, BATCH_AXIS))
        outs[rows * cols] = phase(
            f"distributed_combine_{rows * cols}card",
            lambda: distributed_combine(tpk, powed, signs, mesh),
            lambda out: _eq(out, tms, "distributed_combine"))
    assert outs[1] == outs[4]

    sharded_ddleq(sizes, sk, pk, rng)


def sharded_ddleq(sizes: Sizes, sk, pk, rng: random.Random) -> None:
    """Sharded DDLEQ prove + verify on the flat (proof, instance) batch
    axis of 4 cards, compared with the unsharded call; the 1-card run has
    the main path's shapes, so it reuses its programs."""
    from paillier_tpu.core import homomorphic as hom
    from paillier_tpu.core.encrypt import nested_encrypt
    from paillier_tpu.parallel.mesh import make_mesh
    from paillier_tpu.zk.ddleq import prove, verify

    P = sizes.proofs
    dms = [rng.randrange(pk.n) for _ in range(P)]
    r = random.Random(0xDD1E)
    ct1 = nested_encrypt(pk, dms, r)
    ct2, a_l, b_l = hom.nested_randomize(pk, ct1, r)
    proofs = {}
    for n, mesh in ((1, None), (4, make_mesh(4))):
        def ddleq():
            proof = prove(sk, ct1, ct2, a_l, b_l, sizes.secpar,
                          random.Random(0x5EC), mesh=mesh)
            return proof, verify(pk, ct1, ct2, proof, mesh=mesh)

        def ddleq_ok(out):
            assert len(out[1]) == P and all(out[1]), out[1]

        proofs[n] = phase(f"ddleq_{n}card", ddleq, ddleq_ok)[0]
    for field in ("x", "y", "alpha", "e", "f"):
        assert np.array_equal(np.asarray(getattr(proofs[1], field)),
                              np.asarray(getattr(proofs[4], field))), field


def _eq(got, want, what: str) -> None:
    if got != want:
        bad = sum(g != w for g, w in zip(got, want)) + abs(len(got)
                                                          - len(want))
        raise AssertionError(f"{what}: {bad}/{len(want)} values differ "
                             "from the reference")


def main(argv: list[str]) -> int:
    four = "--four" in argv
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    if four and len(devs) < 4:
        print(f"--four needs 4 GPUs; JAX found {len(devs)}", file=sys.stderr)
        return 2
    from paillier_tpu import native
    from paillier_tpu.config import use_compile_cache
    print(f"compile cache: {use_compile_cache()}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(f"device kind: {devs[0].device_kind}; devices: {len(devs)}; "
          f"native GMP host runtime: {native.available()}", flush=True)
    t0 = time.perf_counter()
    sizes = Sizes()
    rng = random.Random(0x5A0CE)
    if four:
        four_cards(sizes, rng)
    else:
        int8_dot_phase(sizes)
        main_path(sizes, rng)
    print(f"total_s={time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
