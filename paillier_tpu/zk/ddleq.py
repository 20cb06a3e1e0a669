"""DDLEQ zero-knowledge proofs of nested re-encryption (reference:
ddleq.go:9-153).

Proves ct2 = ct1^(a^n mod n^2) * b^(n^2) mod n^3 (the NestedRandomize
relation) without revealing (a, b).  A proof is ``secpar`` independent
Fiat-Shamir instances, each with soundness 1/2.

Batching (the reference loops instances sequentially,
ddleq.go:32-37): all (proof, instance) pairs form one flat batch axis
and the whole pipeline stays on device —

* every modexp is one batched ladder (shared-exponent or per-element
  device-extracted digits);
* Fiat-Shamir challenges run through the vectorized device SHA-256
  (ops/sha256.py), preserving the reference oracle's skip-first-input
  quirk (random_oracle.go:24-26): ct1.C is not bound by the digest;
* the only host arithmetic is one *per-proof* (not per-instance) batch
  of modular inverses (native GMP, threaded), using t^{-e^n} =
  (t^{-1})^{e^n} so B inverses replace B*secpar;
* randomness arrives as vectorized limb tensors
  (ops.random.random_units_limbs), never via per-element Python loops.

Multi-chip (BASELINE config #5, 64k proofs): pass ``mesh=`` to
:func:`prove`/:func:`verify` and the device stages run under
``shard_map`` with the (proof, instance) batch sharded over the mesh's
batch axis.  Every stage is elementwise over that axis, so the sharded
path needs no collectives at all — communication is exactly the final
[B*S] verdict gather.

Proof fields are limb tensors [B, S, limbs]; ``to_ints``/``from_ints``
convert to the reference's per-instance integer view for tests and
serialization.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..bigint import host
from ..bigint import limbmm as lm
from ..bigint import montgomery as mont
from ..bigint import vpu
from ..core import homomorphic as hom
from ..core.keys import (LEVEL_TWO, Ciphertext, PublicKey, SecretKey,
                         decode_batch, encode_batch)
from ..ops import random as prand
from ..ops.sha256 import concat_be, limbs_to_be_bytes, sha256_bytes


@dataclass
class DDLEQProof:
    """Batched proof: B proofs x S instances, limb tensors (the reference
    DDLEQProof holds S integer instances for one pair; ddleq.go:15-19)."""

    x: jnp.ndarray        # uint32 [B, S, L]   (x < n)
    y: jnp.ndarray        # uint32 [B, S, L]   (y < n)
    alpha: jnp.ndarray    # uint32 [B, S, 3L]  (mod n^3)
    e: jnp.ndarray        # uint32 [B, S, 2L]  (mod n^2)
    f: jnp.ndarray        # uint32 [B, S, 3L]  (mod n^3)

    @property
    def secpar(self) -> int:
        return self.x.shape[1]

    def to_ints(self) -> dict:
        """Per-instance integer view {field: [B][S] ints}."""
        out = {}
        for name in ("x", "y", "alpha", "e", "f"):
            arr = np.asarray(jax.device_get(getattr(self, name)))
            B, S, L = arr.shape
            flat = host.limbs_to_ints(arr.reshape(B * S, L))
            out[name] = [flat[i * S:(i + 1) * S] for i in range(B)]
        return out

    @classmethod
    def from_ints(cls, x, y, alpha, e, f, L: int) -> "DDLEQProof":
        def enc(rows, width):
            B, S = len(rows), len(rows[0])
            flat = [v for row in rows for v in row]
            return jnp.asarray(host.ints_to_limbs(flat, width)
                               ).reshape(B, S, width)
        return cls(x=enc(x, L), y=enc(y, L), alpha=enc(alpha, 3 * L),
                   e=enc(e, 2 * L), f=enc(f, 3 * L))


def _challenge_bits(c2_rep: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray,
                    alpha: jnp.ndarray) -> jnp.ndarray:
    """Fiat-Shamir bit per instance = SHA256(c2 || x || y || alpha) mod 2
    (ddleq.go:91 via random_oracle.go:10-32; ct1.C is skipped by the
    oracle quirk).  All inputs are minimal big-endian encodings."""
    parts = [limbs_to_be_bytes(c2_rep), limbs_to_be_bytes(x),
             limbs_to_be_bytes(y), limbs_to_be_bytes(alpha)]
    out_len = sum(p[0].shape[-1] for p in parts)
    buf, ln = concat_be(parts, out_len)
    digest = sha256_bytes(buf, ln, max_len=out_len)
    return digest[:, 7] & 1                      # digest mod 2


def _shard_flat(mesh, dk, stage_name, window, fn, *arrays):
    """Run ``fn(*arrays)`` under shard_map with every array's leading
    (flattened proof-instance) axis sharded over the mesh batch axis.
    All DDLEQ stages are elementwise over that axis — no collectives.

    The jitted sharded stage is cached in ``dk.jit_cache`` keyed by
    (stage name, shapes, window, mesh) so chunked workloads (config #5:
    64k proofs in chunks) reuse one compilation per stage instead of
    retracing every call (the same pattern as
    parallel/collective.py's sharded_aggregate)."""
    from ..parallel.collective import _mesh_key
    from ..parallel.mesh import BATCH_AXIS
    n_dev = int(np.prod(list(mesh.shape.values())))
    B0 = arrays[0].shape[0]
    if B0 % n_dev:
        raise ValueError(f"flat batch {B0} must divide the {n_dev}-device "
                         "mesh (pad the proof batch)")
    # The sharded body runs engine kernels under jit: build the RNS
    # engines eagerly first (DeviceKey.rns must never be constructed
    # inside a trace; keys.py:140-150).
    if dk.use_rns():
        dk.rns(1)
        dk.rns(2)
    key = ("ddleq", stage_name, window,
           tuple((a.shape, str(a.dtype)) for a in arrays), _mesh_key(mesh))
    if key not in dk.jit_cache:
        spec_in = tuple(P(BATCH_AXIS, *([None] * (a.ndim - 1)))
                        for a in arrays)
        wrapped = shard_map(fn, mesh=mesh, in_specs=spec_in,
                            out_specs=P(BATCH_AXIS), check_vma=False)
        dk.jit_cache[key] = jax.jit(wrapped)
    return dk.jit_cache[key](*arrays)


class _CrtN3Plans:
    """Prover-side CRT split of the per-element n^3 ladders.

    The prover knows p and q, so n^3 = p^3 * q^3 and every per-element
    modexp mod n^3 can run as TWO half-width ladders (mod p^3 and mod
    q^3) plus a Garner recombine.  Each half-width Montgomery multiply
    costs ~(1/2)^2 of the full-width one in int8 MACs and halves the
    per-digit 2^w-way table select, so the pair costs ~1/2 of the
    full-width ladder, mirroring core/decrypt.py's level-1 CRT fast path
    one level up.  The verifier has no factors and keeps the full-width
    path; proofs are bit-identical either way (same mathematical value).

    reference: ddleq.go:55-127 computes these powers sequentially with
    libgmp at full width; the split has no counterpart there.
    """

    def __init__(self, sk: SecretKey, L: int):
        from ..bigint.engine import make_engine
        p, q = sk.p, sk.q
        p3, q3 = p ** 3, q ** 3
        Lh = host.limbs_for_bits(max(p3.bit_length(), q3.bit_length()))
        self.Lh, self.L3 = Lh, 3 * L
        # base mod p^3 / q^3: fold the 3L-wide operand
        self.fold_p3 = lm.FoldPlan.build(p3, 3 * L)
        self.fold_q3 = lm.FoldPlan.build(q3, 3 * L)
        self.br_p3 = lm.BarrettPlan.build(p3)
        self.br_q3 = lm.BarrettPlan.build(q3)
        self.eng_p = make_engine(p3, Lh)
        self.eng_q = make_engine(q3, Lh)
        # Garner: m = mp + p^3 * ((mq - mp) * (p^3)^{-1} mod q^3).
        # mp < p^3 may exceed q^3 severalfold (p/q < 2 only bounds the
        # cube ratio by 8), so mp is folded mod q^3 before the subtract.
        self.fold_pq = lm.FoldPlan.build(q3, Lh)
        self.pinv = lm.ModMulConstPlan.build(pow(p3, -1, q3), q3, Lh)
        self.mul_p3 = lm.ConstMulPlan.build(p3, Lh, 3 * L)
        self.q3_limbs = jnp.asarray(host.int_to_limbs(q3, Lh))
        # group orders mod p^3 / q^3: shared HOST exponents reduce mod
        # these (valid for units — every DDLEQ operand is a unit), so
        # the shared ladders also drop ~1/4 of their digits
        self.ord_p = p * p * (p - 1)
        self.ord_q = q * q * (q - 1)


def _crt_combine(pl: _CrtN3Plans, mp: jnp.ndarray,
                 mq: jnp.ndarray) -> jnp.ndarray:
    """Garner: m = mp + p^3 * ((mq - mp) * (p^3)^{-1} mod q^3), [..., 3L]."""
    Lh = pl.Lh
    qb = jnp.broadcast_to(pl.q3_limbs, mp.shape)
    mp_q = lm.fold_mod(mp, pl.fold_pq, pl.br_q3)[..., :Lh]
    diff, borrow = vpu.sub(mq, mp_q)
    fixed, _ = vpu.add(diff, qb)
    diff = jnp.where(borrow[..., None] != 0, fixed, diff)
    t = lm.modmul_const(diff, pl.pinv, pl.br_q3)
    pt = lm.const_mul(t, pl.mul_p3)                   # t * p^3 < n^3, exact
    m, _ = vpu.add(pt, jnp.pad(mp, [(0, 0)] * (mp.ndim - 1)
                               + [(0, pl.L3 - Lh)]))
    return m


def _crt_pow_n3(pl: _CrtN3Plans, base: jnp.ndarray, digits: jnp.ndarray,
                window: int = 4) -> jnp.ndarray:
    """base^e mod n^3 via half-width ladders mod p^3 / q^3 (prover only;
    ``digits`` is the per-element MSB-first exponent, shared by both
    halves).  Returns [..., 3L] limbs, exactly the full-width result."""
    Lh = pl.Lh

    def half(fold, br, eng):
        bm = lm.fold_mod(base, fold, br)[..., :Lh]
        u = eng.pow(eng.from_limbs(bm), digits, window)
        return eng.to_limbs_mod(u)[..., :Lh]

    mp = half(pl.fold_p3, pl.br_p3, pl.eng_p)
    mq = half(pl.fold_q3, pl.br_q3, pl.eng_q)
    return _crt_combine(pl, mp, mq)


def _crt_pow_shared_n3(pl: _CrtN3Plans, base: jnp.ndarray,
                       e_int: int) -> jnp.ndarray:
    """base^e mod n^3 for a shared host exponent, prover only: half-width
    ladders AND the exponent reduced mod each group order p^2(p-1) /
    q^2(q-1) (valid for units; every DDLEQ operand is one), dropping
    ~1/4 of the ladder digits on top of the width split."""
    Lh = pl.Lh

    def half(fold, br, eng, ordm):
        bm = lm.fold_mod(base, fold, br)[..., :Lh]
        u = eng.pow_shared(eng.from_limbs(bm), e_int % ordm)
        return eng.to_limbs_mod(u)[..., :Lh]

    mp = half(pl.fold_p3, pl.br_p3, pl.eng_p, pl.ord_p)
    mq = half(pl.fold_q3, pl.br_q3, pl.eng_q, pl.ord_q)
    return _crt_combine(pl, mp, mq)


def _crt_plans(sk: SecretKey, dk) -> _CrtN3Plans:
    """Per-key cached prover CRT plans (the two half-width engines are
    eager host-side constructions — never build them inside a trace)."""
    key = ("ddleq_crt_n3", dk.L)
    if key not in dk.jit_cache:
        dk.jit_cache[key] = _CrtN3Plans(sk, dk.L)
    return dk.jit_cache[key]


def prove(sk: SecretKey, ct1: Ciphertext, ct2: Ciphertext,
          a_list: Sequence[int], b_list: Sequence[int], secpar: int,
          rng=None, window: int = 4, mesh=None,
          use_crt: bool = True) -> DDLEQProof:
    """ProveDDLEQ (ddleq.go:27-40, 55-127), batched over proofs and
    instances.  Requires the secret key (randomness extraction).

    With ``mesh``, the two per-instance device stages (commitments and
    responses) run sharded over the mesh batch axis.  ``use_crt`` routes
    the three per-(proof,instance) n^3 ladders through the prover's
    p^3/q^3 half-width CRT split (bit-identical proofs, ~2x the ladder
    throughput); the verifier path never depends on it."""
    rng = rng or prand.make_rng()
    if ct1.level != LEVEL_TWO or ct2.level != LEVEL_TWO:
        raise ValueError("DDLEQ operates on level-2 (nested) ciphertexts")
    dk = sk.device()
    L = dk.L
    n, n2, n3 = sk.n, sk.n2, sk.n3
    c1 = ct1.c.reshape((-1, 3 * L))
    c2 = ct2.c.reshape((-1, 3 * L))
    B = c1.shape[0]
    S = secpar
    BS = B * S

    # a^n mod n^2, device (shared exponent n), reused for both the sanity
    # check and t = s^(a^n) * b
    A = encode_batch(a_list, 2 * L)
    an = dk.pow_int(1, A, n, window)                      # [B, 2L]
    an_digits = mont.limbs_to_digits(an, 4)

    # sanity-check the relation on device (ddleq.go:62-69)
    Bv = encode_batch(b_list, 3 * L)
    bn2 = dk.pow_int(2, Bv, n2, window)
    c1an = dk.pow(2, c1, an_digits, 4)
    rel = mont.modmul(dk.ctx_n3, c1an, bn2)
    if not bool(jnp.all(rel == c2)):
        raise ValueError(
            "cannot prove re-encryption because inputs are wrong")

    # s = extracted randomness of ct1, one per proof (ddleq.go:103)
    s_vals = hom.extract_randomness(sk, ct1, window)
    S3 = encode_batch(s_vals, 3 * L)                      # [B, 3L]

    # per-(proof, instance) randomness, vectorized (ddleq.go:71-79)
    X = jnp.asarray(prand.random_units_limbs(n, BS, rng, L))   # [BS, L]
    Y = jnp.asarray(prand.random_units_limbs(n, BS, rng, L))

    X2 = jnp.pad(X, ((0, 0), (0, L)))                     # [BS, 2L]
    Y3 = jnp.pad(Y, ((0, 0), (0, 2 * L)))                 # [BS, 3L]

    c1_rep = jnp.repeat(c1, S, axis=0)
    c2_rep = jnp.repeat(c2, S, axis=0)

    # prover CRT split for the BS-sized per-element n^3 ladders (built
    # eagerly: half-width engine construction must precede any trace)
    crt = _crt_plans(sk, dk) if use_crt else None

    def pow_n3(base, digits):
        if crt is not None:
            return _crt_pow_n3(crt, base, digits, 4)
        return dk.pow(2, base, digits, 4)

    def commit_stage(x2, y3, c1r, c2r):
        """x^n, y^(n^2), alpha = ct1^(x^n) * y^(n^2), challenge bits
        (ddleq.go:81-91).  Elementwise over the flat instance axis."""
        xn = dk.pow_int(1, x2, n, window)                 # [., 2L]
        if crt is not None:                               # [., 3L]
            yn2 = _crt_pow_shared_n3(crt, y3, n2)
        else:
            yn2 = dk.pow_int(2, y3, n2, window)
        xd = mont.limbs_to_digits(xn, 4)
        c1x = pow_n3(c1r, xd)
        alph = mont.modmul(dk.ctx_n3, c1x, yn2)
        ch = _challenge_bits(c2r, x2[..., :L], y3[..., :L], alph)
        return xn, alph, ch

    stage_tag = "crt" if crt is not None else "full"
    if mesh is None:
        xn, alpha, chal = commit_stage(X2, Y3, c1_rep, c2_rep)
    else:
        xn, alpha, chal = _shard_flat(mesh, dk, "commit-" + stage_tag,
                                      window, commit_stage,
                                      X2, Y3, c1_rep, c2_rep)
    sel = (chal != 0)[:, None]

    # e = chal ? x * a^{-1} mod n^2 : x (ddleq.go:94-99); a^{-1} is one
    # *per-proof* native batch inversion
    ainv = host.modinv_batch([a % n2 for a in a_list], n2)
    AI = jnp.repeat(encode_batch(ainv, 2 * L), S, axis=0)

    # f = chal ? y * s^(x^n) * (s^(a^n) * b)^{-(e^n)} mod n^3 : y
    # (ddleq.go:101-115) with t^{-e^n} = (t^{-1})^{e^n}: B inverses, not BS
    s_an = dk.pow(2, S3, an_digits, 4)                    # [B, 3L]
    t = mont.modmul(dk.ctx_n3, s_an, Bv)
    t_ints = decode_batch(t)
    tinv = host.modinv_batch(t_ints, n3)
    TI = jnp.repeat(encode_batch(tinv, 3 * L), S, axis=0)
    S3_rep = jnp.repeat(S3, S, axis=0)

    def response_stage(selb, x2, y3, ai, ti, s3r, xnr):
        """e and f responses (ddleq.go:94-115), elementwise over the
        flat instance axis."""
        xa = mont.modmul(dk.ctx_n2, x2, ai)
        e_out = jnp.where(selb, xa, x2)                   # [., 2L]
        en = dk.pow_int(1, e_out, n, window)              # e^n mod n^2
        ed = mont.limbs_to_digits(en, 4)
        t_inv_pow = pow_n3(ti, ed)                        # t^{-e^n}
        xd = mont.limbs_to_digits(xnr, 4)
        s_xn = pow_n3(s3r, xd)
        f_true = mont.modmul(dk.ctx_n3,
                             mont.modmul(dk.ctx_n3, y3, s_xn), t_inv_pow)
        f_out = jnp.where(selb, f_true, y3)
        return e_out, f_out

    if mesh is None:
        e, f = response_stage(sel, X2, Y3, AI, TI, S3_rep, xn)
    else:
        e, f = _shard_flat(mesh, dk, "response-" + stage_tag, window,
                           response_stage, sel, X2, Y3, AI, TI, S3_rep, xn)

    shape = lambda a: a.reshape(B, S, a.shape[-1])
    return DDLEQProof(x=shape(X), y=shape(Y), alpha=shape(alpha),
                      e=shape(e), f=shape(f))


def pipeline_prove_verify(sk: SecretKey, jobs, secpar: int,
                          window: int = 4, mesh=None, workers: int = 2,
                          verify_pk: PublicKey | None = None):
    """Prove+verify a stream of chunks with chunk i's HOST work (native
    inverses, digit packing, decode/encode) overlapped against chunk
    i±1's device ladders.

    ``jobs`` is an iterable of (ct1, ct2, a_list, b_list, rng) chunk
    tuples.  Two worker threads are enough: JAX dispatch is async, so
    while one thread blocks on a device readback or runs GMP inverses
    (which release the GIL), the other thread's dispatched ladders keep
    the device busy.  Every compiled kernel must already be warm (run one
    chunk serially first) — concurrent first-compiles would race the
    jit cache.  Yields one List[bool] of per-proof verdicts per chunk,
    in order."""
    from concurrent.futures import ThreadPoolExecutor
    pk = verify_pk or sk.public()

    def one(job):
        ct1, ct2, a_l, b_l, rng = job
        proof = prove(sk, ct1, ct2, a_l, b_l, secpar, rng, window, mesh)
        return verify(pk, ct1, ct2, proof, window, mesh)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        yield from ex.map(one, jobs)


def verify(pk: PublicKey, ct1: Ciphertext, ct2: Ciphertext,
           proof: DDLEQProof, window: int = 4, mesh=None) -> List[bool]:
    """VerifyDDLEQProof (ddleq.go:44-53, 129-153), batched on device.
    Returns one bool per proof (all S instances must check).

    With ``mesh``, the whole check runs sharded over the mesh batch axis
    (one [B*S] bool gather is the only cross-device traffic)."""
    dk = pk.device()
    L = dk.L
    n, n2 = pk.n, pk.n2
    c1 = ct1.c.reshape((-1, 3 * L))
    c2 = ct2.c.reshape((-1, 3 * L))
    B, S = proof.x.shape[:2]

    X = proof.x.reshape(B * S, L)
    Y = proof.y.reshape(B * S, L)
    alpha = proof.alpha.reshape(B * S, 3 * L)
    E = proof.e.reshape(B * S, 2 * L)
    F = proof.f.reshape(B * S, 3 * L)

    c1_rep = jnp.repeat(c1, S, axis=0)
    c2_rep = jnp.repeat(c2, S, axis=0)

    def check_stage(x, y, alph, e_in, f_in, c1r, c2r):
        ch = _challenge_bits(c2r, x, y, alph)
        selb = (ch != 0)[:, None]
        en = dk.pow_int(1, e_in, n, window)               # e^n mod n^2
        fn2 = dk.pow_int(2, f_in, n2, window)             # f^(n^2) mod n^3
        base = jnp.where(selb, c2r, c1r)
        ed = mont.limbs_to_digits(en, 4)
        powed = dk.pow(2, base, ed, 4)
        check = mont.modmul(dk.ctx_n3, powed, fn2)
        return jnp.all(check == alph, axis=-1)

    if mesh is None:
        ok = check_stage(X, Y, alpha, E, F, c1_rep, c2_rep)
    else:
        ok = _shard_flat(mesh, dk, "check", window, check_stage,
                         X, Y, alpha, E, F, c1_rep, c2_rep)
    ok = ok.reshape(B, S)
    return [bool(v) for v in np.asarray(jax.device_get(jnp.all(ok, axis=1)))]
