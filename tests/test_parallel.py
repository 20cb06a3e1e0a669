"""Multi-device tests on the virtual 8-device CPU mesh: sharded
encryption (pure data parallelism), the sharded aggregation collective,
and the server-axis threshold combine."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paillier_tpu.core import homomorphic as hom
from paillier_tpu.core.decrypt import Decryptor
from paillier_tpu.core.encrypt import Encryptor
from paillier_tpu.core.keys import LEVEL_ONE, Ciphertext, decode_batch
from paillier_tpu.bigint import montgomery as mont
from paillier_tpu.parallel.collective import (distributed_combine,
                                              sharded_aggregate)
from paillier_tpu.parallel.mesh import (BATCH_AXIS, SERVER_AXIS, make_mesh,
                                        shard_batch)
from paillier_tpu.threshold.decrypt import compute_lambda, partial_decrypt
from paillier_tpu.threshold.keygen import generate_threshold_keys


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


class TestShardedDataParallel:
    def test_sharded_encrypt_decrypt(self, keypair_128, rng):
        sk, pk = keypair_128
        mesh = make_mesh()
        enc = Encryptor(pk, LEVEL_ONE, rng=rng)
        dec = Decryptor(sk, LEVEL_ONE)
        ms = [rng.randrange(pk.n) for _ in range(16)]
        ct = enc.encrypt(ms)
        ct_sharded = Ciphertext(c=shard_batch(ct.c, mesh), level=LEVEL_ONE)
        # decryption over sharded inputs is automatically SPMD
        assert dec.decrypt(ct_sharded) == ms

    def test_sharded_aggregate(self, keypair_128, rng):
        sk, pk = keypair_128
        mesh = make_mesh()
        enc = Encryptor(pk, LEVEL_ONE, rng=rng)
        dec = Decryptor(sk, LEVEL_ONE)
        vals = [rng.randrange(10_000) for _ in range(64)]
        ct = enc.encrypt(vals)
        ct_sharded = Ciphertext(c=shard_batch(ct.c, mesh), level=LEVEL_ONE)
        agg = sharded_aggregate(pk, ct_sharded, mesh)
        got = dec.decrypt(Ciphertext(c=agg.c[None], level=LEVEL_ONE))
        assert got == [sum(vals) % pk.n]
        # matches the single-device aggregation path bit-exactly
        single = hom.aggregate(pk, ct, axis=0)
        assert decode_batch(agg.c[None]) == decode_batch(single.c[None])


class TestShardedDDLEQ:
    def test_sharded_prove_verify_matches_single_device(self, keypair_128):
        from paillier_tpu.core.encrypt import nested_encrypt
        from paillier_tpu.zk.ddleq import prove, verify
        sk, pk = keypair_128
        mesh = make_mesh()
        rng = random.Random(55)
        ms = [rng.randrange(pk.n) for _ in range(2)]
        ct1 = nested_encrypt(pk, ms, rng)
        ct2, a_l, b_l = hom.nested_randomize(pk, ct1, rng)

        # same host seed -> sharded and single-device proofs are
        # bit-identical (multi-host determinism, SURVEY hard part #7)
        seed_a, seed_b = random.Random(9), random.Random(9)
        p_single = prove(sk, ct1, ct2, a_l, b_l, 8, seed_a)
        p_shard = prove(sk, ct1, ct2, a_l, b_l, 8, seed_b, mesh=mesh)
        for field in ("x", "y", "alpha", "e", "f"):
            assert bool(jnp.all(getattr(p_single, field)
                                == getattr(p_shard, field))), field

        # sharded verify accepts, and cross-checks the unsharded path
        assert verify(pk, ct1, ct2, p_shard, mesh=mesh) == [True, True]
        assert verify(pk, ct1, ct2, p_shard) == [True, True]

        # tampering one instance flips only that proof under sharded verify
        bad = p_shard.e.at[1, 3, 0].add(1)
        import dataclasses
        tampered = dataclasses.replace(p_shard, e=bad)
        assert verify(pk, ct1, ct2, tampered, mesh=mesh) == [True, False]

    def test_sharded_prove_verify_forced_rns(self, keypair_128, monkeypatch):
        """The sharded DDLEQ path with the RNS engine active (the
        accelerator configuration): the engines must be built eagerly
        before the shard_map trace and results must match
        the unsharded run bit-exactly."""
        import dataclasses
        from paillier_tpu.core.encrypt import nested_encrypt
        from paillier_tpu.zk.ddleq import prove, verify
        monkeypatch.setenv("PAILLIER_TPU_FORCE_RNS", "1")
        sk0, _ = keypair_128
        # fresh key objects so cached non-RNS jits don't leak in
        sk = type(sk0)(**{f.name: getattr(sk0, f.name)
                          for f in dataclasses.fields(sk0)})
        pk = sk.public()
        mesh = make_mesh()
        rng = random.Random(56)
        ms = [rng.randrange(pk.n) for _ in range(2)]
        ct1 = nested_encrypt(pk, ms, rng)
        ct2, a_l, b_l = hom.nested_randomize(pk, ct1, rng)
        seed_a, seed_b = random.Random(10), random.Random(10)
        p_single = prove(sk, ct1, ct2, a_l, b_l, 8, seed_a)
        p_shard = prove(sk, ct1, ct2, a_l, b_l, 8, seed_b, mesh=mesh)
        for field in ("x", "y", "alpha", "e", "f"):
            assert bool(jnp.all(getattr(p_single, field)
                                == getattr(p_shard, field))), field
        assert verify(pk, ct1, ct2, p_shard, mesh=mesh) == [True, True]


class TestDistributedThreshold:
    def test_server_axis_combine(self, rng):
        l, t = 4, 3
        keys = generate_threshold_keys(64, l, t, rng)
        tpk = keys[0].public()
        enc = Encryptor(tpk, LEVEL_ONE, rng=rng)
        ms = [rng.randrange(tpk.n) for _ in range(4)]
        ct = enc.encrypt(ms)

        # mesh: 4 server rows x 2 batch cols
        mesh = make_mesh(8, servers=4)
        assert mesh.shape[SERVER_AXIS] == 4 and mesh.shape[BATCH_AXIS] == 2

        # each server computes its Lagrange-weighted contribution locally
        use = keys[:l]
        ids = [k.id for k in use]
        dk = tpk.device()
        powed_rows = []
        signs = []
        for k in use:
            lam2 = 2 * compute_lambda(tpk, k.id, ids)
            signs.append(1 if lam2 >= 0 else -1)
            pd = partial_decrypt(k, ct)
            powed_rows.append(mont.mont_pow(dk.ctx_n2, pd.c, abs(lam2)))
        server_powed = jnp.stack(powed_rows)             # [S, B, 2L]

        got = distributed_combine(tpk, server_powed, signs, mesh)
        assert got == ms
