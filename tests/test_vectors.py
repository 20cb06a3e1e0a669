"""Frozen cross-implementation vector corpus (tests/vectors.json).

The corpus pins (key, m, r) -> ciphertext for regular/alternative
encryption at levels 1 and 2, decryption through both the recovery and
CRT paths, a full threshold transcript (partial decryptions + share
ZKPs + combine) and a DDLEQ transcript with fixed randomness.

Expected values for the encryption/decryption/threshold vectors were
computed with pure-Python big-int formulas transcribed from the Go
reference (see scripts/gen_vectors.py) — if a kernel optimization
changes any output bit, these tests fail even though the library's
internal oracles would have drifted along with it.
The DDLEQ transcript is a *self-regression freeze*: it was generated by
the library with fixed randomness (its relation and challenge bits are
checked against independent pure-int formulas in gen_vectors.py, but
the alpha/e/f values pin our own output, not a second implementation).
"""

import json
import os

import pytest

from paillier_tpu.core.decrypt import Decryptor
from paillier_tpu.core.encrypt import Encryptor
from paillier_tpu.core.keys import (ALTERNATIVE, LEVEL_ONE, LEVEL_TWO,
                                    Ciphertext, PublicKey, SecretKey,
                                    decode_batch, encode_batch)
from paillier_tpu.threshold.decrypt import combine_ints, partial_decrypt_int
from paillier_tpu.threshold.keys import (PartialDecryption,
                                         PartialDecryptionZKP,
                                         ThresholdPublicKey,
                                         ThresholdSecretKey)
from paillier_tpu.threshold.zkp import verify_proof
from paillier_tpu.zk.ddleq import DDLEQProof, verify


@pytest.fixture(scope="module")
def vectors():
    path = os.path.join(os.path.dirname(__file__), "vectors.json")
    with open(path) as fh:
        return json.load(fh)


def _sk(entry) -> SecretKey:
    return SecretKey(n=entry["n"], g=entry["g"], h=entry["h"],
                     k=entry["k"], bits=entry["bits"], lam=entry["lam"],
                     p=entry["p"], q=entry["q"])


class TestCoreVectors:
    def test_encrypt(self, vectors):
        for entry in vectors["keys"]:
            sk = _sk(entry)
            pk = sk.public()
            for case in entry["cases"]:
                level = LEVEL_ONE if case["s"] == 1 else LEVEL_TWO
                method = (ALTERNATIVE if case["method"] == "alternative"
                          else "regular")
                enc = Encryptor(pk, level, method=method)
                got = decode_batch(enc.encrypt(case["m"], case["r"]).c)
                assert got == case["c"], (
                    f"bits={entry['bits']} {case['method']} s={case['s']}")

    def test_decrypt_recovery_and_crt(self, vectors):
        for entry in vectors["keys"]:
            sk = _sk(entry)
            L = sk.device().L
            for case in entry["cases"]:
                if case["method"] != "regular":
                    continue
                s = case["s"]
                level = LEVEL_ONE if s == 1 else LEVEL_TWO
                ct = Ciphertext(c=encode_batch(case["c"], (s + 1) * L),
                                level=level)
                want = [m % sk.n ** s for m in case["m"]]
                assert Decryptor(sk, level).decrypt(ct) == want
                if s == 1:
                    assert Decryptor(sk, level, crt=True).decrypt(ct) == want


class TestThresholdVectors:
    def test_partials_zkps_combine(self, vectors):
        tv = vectors["threshold"]
        base = dict(n=tv["n"], g=tv["g"], h=tv["h"], k=tv["k"],
                    bits=tv["bits"], l=tv["l"], t=tv["t"], v=tv["v"],
                    vi=tuple(tv["vi"]))
        tpk = ThresholdPublicKey(**base)
        c, msg = tv["c"], tv["m"]
        for sh, want in zip(tv["shares"], tv["partials"]):
            tsk = ThresholdSecretKey(**base, id=sh["id"],
                                     share=sh["share"])
            assert partial_decrypt_int(tsk, c).decryption == want
        # pinned Fiat-Shamir transcripts verify (and a tampered one fails)
        for zk, want in zip(tv["zkps"], tv["partials"]):
            pd = PartialDecryptionZKP(id=zk["id"], decryption=want,
                                      key=tpk, e=zk["e"], z=zk["z"], c=c)
            assert verify_proof(pd)
            bad = PartialDecryptionZKP(id=zk["id"], decryption=want,
                                       key=tpk, e=zk["e"] + 1, z=zk["z"],
                                       c=c)
            assert not verify_proof(bad)
        shares = [PartialDecryption(id=sh["id"], decryption=pdv)
                  for sh, pdv in zip(tv["shares"], tv["partials"])]
        assert combine_ints(tpk, shares[:tv["t"]]) == msg


class TestDDLEQVectors:
    def test_transcript_verifies(self, vectors):
        dv = vectors["ddleq"]
        sk = _sk(dv)
        pk = sk.public()
        L = pk.device().L
        ct1 = Ciphertext(c=encode_batch(dv["ct1"], 3 * L), level=LEVEL_TWO)
        ct2 = Ciphertext(c=encode_batch(dv["ct2"], 3 * L), level=LEVEL_TWO)
        proof = DDLEQProof.from_ints(
            dv["proof"]["x"], dv["proof"]["y"], dv["proof"]["alpha"],
            dv["proof"]["e"], dv["proof"]["f"], L)
        assert verify(pk, ct1, ct2, proof) == [True, True]
        # soundness: swapping the ciphertexts must break every transcript
        assert verify(pk, ct2, ct1, proof) == [False, False]
