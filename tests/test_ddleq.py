"""DDLEQ completeness + soundness tests (reference: ddleq_test.go:9-72)."""

import random

import pytest

from paillier_tpu.core import homomorphic as hom
from paillier_tpu.core.encrypt import nested_encrypt
from paillier_tpu.core.keygen import keygen
from paillier_tpu.ops.oracle import go_bytes, oracle_bit, oracle_digest
from paillier_tpu.zk.ddleq import (DDLEQProof, pipeline_prove_verify,
                                   prove, verify)

SECPAR = 8


@pytest.fixture(scope="module")
def setup(rng):
    sk, pk = keygen(128, rng)
    ms = [rng.randrange(pk.n) for _ in range(3)]
    ct1 = nested_encrypt(pk, ms, rng)
    ct2, a_l, b_l = hom.nested_randomize(pk, ct1, rng)
    return sk, pk, ct1, ct2, a_l, b_l


class TestOracle:
    def test_go_bytes(self):
        assert go_bytes(0) == b""
        assert go_bytes(1) == b"\x01"
        assert go_bytes(256) == b"\x01\x00"

    def test_skip_first_quirk(self):
        # random_oracle.go:24-26: first argument is skipped
        assert oracle_digest(1, 2, 3) == oracle_digest(999, 2, 3)
        assert oracle_digest(1, 2, 3) != oracle_digest(1, 3, 2)

    def test_bit_is_parity_of_digest(self):
        d = int.from_bytes(oracle_digest(0, 5, 7), "big")
        assert oracle_bit(0, 5, 7) == (d % 2 == 1)


class TestDdleq:
    def test_completeness(self, setup, rng):
        # ddleq_test.go:9-52
        sk, pk, ct1, ct2, a_l, b_l = setup
        proof = prove(sk, ct1, ct2, a_l, b_l, SECPAR, rng)
        assert proof.secpar == SECPAR
        assert verify(pk, ct1, ct2, proof) == [True] * 3

    def test_pipeline_prove_verify(self, setup):
        """The 2-deep chunk pipeline (the bench path) yields the same
        verdicts as serial prove+verify, in order."""
        sk, pk, ct1, ct2, a_l, b_l = setup
        jobs = [(ct1, ct2, a_l, b_l, random.Random(1000 + i))
                for i in range(3)]
        outs = list(pipeline_prove_verify(sk, jobs, SECPAR,
                                          verify_pk=pk))
        assert len(outs) == 3
        for ok in outs:
            assert ok == [True] * len(ct1.c)

    def test_crt_split_bit_identical(self, setup):
        """The prover's p^3/q^3 CRT split (half-width ladders + Garner
        recombine) produces bit-identical proofs to the full-width n^3
        ladders under the same randomness stream, and they verify."""
        import numpy as np
        sk, pk, ct1, ct2, a_l, b_l = setup
        pa = prove(sk, ct1, ct2, a_l, b_l, SECPAR, random.Random(77),
                   use_crt=True)
        pb = prove(sk, ct1, ct2, a_l, b_l, SECPAR, random.Random(77),
                   use_crt=False)
        for name in ("x", "y", "alpha", "e", "f"):
            assert np.array_equal(np.asarray(getattr(pa, name)),
                                  np.asarray(getattr(pb, name))), name
        assert verify(pk, ct1, ct2, pa) == [True] * 3

    def test_soundness_fresh_ciphertext(self, setup, rng):
        # ddleq_test.go:54-72: proof must not verify against an unrelated
        # nested ciphertext
        sk, pk, ct1, ct2, a_l, b_l = setup
        proof = prove(sk, ct1, ct2, a_l, b_l, SECPAR, rng)
        ms = [rng.randrange(pk.n) for _ in range(3)]
        ct3 = nested_encrypt(pk, ms, rng)
        results = verify(pk, ct1, ct3, proof)
        assert not any(results)

    def test_tampered_instance_rejected(self, setup, rng):
        sk, pk, ct1, ct2, a_l, b_l = setup
        proof = prove(sk, ct1, ct2, a_l, b_l, SECPAR, rng)
        ints = proof.to_ints()
        ints["f"][0][0] = (ints["f"][0][0] + 1) % pk.n3
        tampered = DDLEQProof.from_ints(L=pk.device().L, **ints)
        results = verify(pk, ct1, ct2, tampered)
        assert results[0] is False or results[0] == False  # noqa: E712
        assert all(results[1:])

    def test_proof_int_roundtrip(self, setup, rng):
        sk, pk, ct1, ct2, a_l, b_l = setup
        proof = prove(sk, ct1, ct2, a_l, b_l, SECPAR, rng)
        ints = proof.to_ints()
        rebuilt = DDLEQProof.from_ints(L=pk.device().L, **ints)
        assert verify(pk, ct1, ct2, rebuilt) == [True] * 3
        # e/f really are mod n^2 / mod n^3 values
        assert all(v < pk.n2 for row in ints["e"] for v in row)
        assert all(v < pk.n3 for row in ints["f"] for v in row)

    def test_wrong_inputs_raise(self, setup, rng):
        sk, pk, ct1, ct2, a_l, b_l = setup
        bad_a = [a + 1 for a in a_l]
        with pytest.raises(ValueError):
            prove(sk, ct1, ct2, bad_a, b_l, SECPAR, rng)

    def test_host_reference_parity(self, setup, rng):
        """Re-verify every instance with pure-Python reference formulas
        (ddleq.go:129-153 + random_oracle.go:10-32): pins the device
        SHA-256 challenge and the device ladders to Go semantics."""
        from paillier_tpu.core.keys import decode_batch
        sk, pk, ct1, ct2, a_l, b_l = setup
        n, n2, n3 = pk.n, pk.n2, pk.n3
        proof = prove(sk, ct1, ct2, a_l, b_l, SECPAR, rng)
        ints = proof.to_ints()
        L = pk.device().L
        c1_vals = decode_batch(ct1.c.reshape((-1, 3 * L)))
        c2_vals = decode_batch(ct2.c.reshape((-1, 3 * L)))
        for i in range(len(c1_vals)):
            for j in range(SECPAR):
                chal = oracle_bit(c1_vals[i], c2_vals[i], ints["x"][i][j],
                                  ints["y"][i][j], ints["alpha"][i][j])
                base = c2_vals[i] if chal else c1_vals[i]
                en = pow(ints["e"][i][j], n, n2)
                want = (pow(base, en, n3)
                        * pow(ints["f"][i][j], n2, n3)) % n3
                assert want == ints["alpha"][i][j]
