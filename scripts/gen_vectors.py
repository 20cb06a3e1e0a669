"""Generate the frozen cross-implementation vector corpus
(tests/vectors.json).

Every expected value is computed here with *pure-Python big-int
formulas* transcribed from the Go reference (paillier.go /
thresholdkey.go / ddleq.go) — an oracle independent of the library's
kernels — then cross-checked against the library before freezing.  The
corpus pins (key, m, r) -> ciphertext for regular/alternative x level
1/2, CRT and recovery decryption, a full threshold transcript (partial
decryptions + share ZKPs) and a DDLEQ transcript with fixed randomness,
so kernel optimizations can never silently change outputs
(anchor style: paillier_test.go:52-156,
thresholdkey_test.go:24-135).

Run from the repo root on the CPU backend:
    PYTHONPATH=. python scripts/gen_vectors.py
"""
import json
import os
import random
import sys

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from paillier_tpu.core import homomorphic as hom
from paillier_tpu.core.decrypt import Decryptor, nested_decrypt
from paillier_tpu.core.encrypt import Encryptor, nested_encrypt
from paillier_tpu.core.keygen import keygen
from paillier_tpu.core.keys import (ALTERNATIVE, LEVEL_ONE, LEVEL_TWO,
                                    decode_batch)
from paillier_tpu.ops.oracle import zkp_hash
from paillier_tpu.threshold.decrypt import (combine, partial_decrypt_int)
from paillier_tpu.threshold.keygen import generate_threshold_keys
from paillier_tpu.zk.ddleq import prove, verify

SEED = 0x5EED0


def py_encrypt_regular(n, s, m, r):
    """c = g^m * r^(n^s) mod n^(s+1), g = n+1 (paillier.go:206-218)."""
    mod = n ** (s + 1)
    return pow(n + 1, m, mod) * pow(r, n ** s, mod) % mod


def py_hs(n, h, s):
    """h1 = (n-h)^n mod n^2; h2 = (n^2-h)^(n^2) mod n^3
    (paillier.go:416-434)."""
    if s == 1:
        return pow(n - h, n, n * n)
    return pow(n * n - h, n * n, n ** 3)


def py_encrypt_alt(n, h, s, m, r):
    """c = g^m * h_s^r mod n^(s+1) (paillier.go:221-238)."""
    mod = n ** (s + 1)
    return pow(n + 1, m, mod) * pow(py_hs(n, h, s), r, mod) % mod


def py_decrypt(n, lam, s, c):
    """Damgard-Jurik recovery (paillier.go:292-340)."""
    mod = n ** (s + 1)
    a = pow(c, lam, mod)
    # recoveryAlgorithm: induction over j = 1..s
    ml = 0
    nj = 1
    for j in range(1, s + 1):
        nj *= n
        t1 = ((pow(a, 1, nj * n) - 1) // n) % nj     # L(a mod n^(j+1))
        t2 = ml
        kfac = 1
        for k in range(2, j + 1):
            kfac *= k
            ml -= 1
            t2 = t2 * ml % nj
            t1 = (t1 - t2 * pow(n, k - 1, nj) * pow(kfac, -1, nj)) % nj
        ml = t1
    return ml * pow(lam, -1, n ** s) % (n ** s)


def main():
    rng = random.Random(SEED)
    out = {"seed": SEED, "keys": [], "threshold": None, "ddleq": None}

    # ---- core vectors at two key sizes ------------------------------------
    for bits in (128, 256):
        sk, pk = keygen(bits, rng)
        n, h, lam = pk.n, pk.h, sk.lam
        entry = {"bits": bits, "n": n, "g": pk.g, "h": h, "k": pk.k,
                 "lam": lam, "p": sk.p, "q": sk.q, "cases": []}
        ms = [0, 1, n - 1] + [rng.randrange(n) for _ in range(3)]
        rs = [rng.randrange(2, n) for _ in ms]
        for level, s in ((LEVEL_ONE, 1), (LEVEL_TWO, 2)):
            ms_l = ms if s == 1 else [m * n + mm for m, mm in zip(ms, ms)]
            # regular
            want = [py_encrypt_regular(n, s, m, r)
                    for m, r in zip(ms_l, rs)]
            enc = Encryptor(pk, level, rng=rng)
            got = decode_batch(enc.encrypt(ms_l, rs).c)
            assert got == want, f"regular enc drift bits={bits} s={s}"
            assert [py_decrypt(n, lam, s, c) for c in want] == [
                m % n ** s for m in ms_l], "python decrypt oracle broken"
            dec = Decryptor(sk, level)
            from paillier_tpu.core.keys import Ciphertext, encode_batch
            ct = Ciphertext(c=encode_batch(want, (s + 1) * pk.device().L),
                            level=level)
            assert dec.decrypt(ct) == [m % n ** s for m in ms_l]
            entry["cases"].append(
                {"method": "regular", "s": s, "m": ms_l, "r": rs,
                 "c": want})
            # alternative (short randomness r < k)
            rs_short = [rng.randrange(pk.k) for _ in ms_l]
            want_alt = [py_encrypt_alt(n, h, s, m, r)
                        for m, r in zip(ms_l, rs_short)]
            enc_a = Encryptor(pk, level, method=ALTERNATIVE, rng=rng)
            got_alt = decode_batch(enc_a.encrypt(ms_l, rs_short).c)
            assert got_alt == want_alt, f"alt enc drift bits={bits} s={s}"
            entry["cases"].append(
                {"method": "alternative", "s": s, "m": ms_l,
                 "r": rs_short, "c": want_alt})
        # CRT decryption pins the same ciphertexts (cases[0])
        out["keys"].append(entry)

    # ---- threshold transcript (64-bit modulus, l=5, t=3) -------------------
    tkeys = generate_threshold_keys(64, 5, 3, rng)
    tpk = tkeys[0].public()
    msg = rng.randrange(tpk.n)
    r_enc = rng.randrange(2, tpk.n)
    c = py_encrypt_regular(tpk.n, 1, msg, r_enc)
    delta = tpk.delta
    partials = [pow(c, 2 * delta * k.share, tpk.n2) for k in tkeys]
    for k, want_pd in zip(tkeys, partials):
        assert partial_decrypt_int(k, c).decryption == want_pd, \
            "partial drift"
    # share ZKPs with pinned prover randomness
    zkps = []
    for k, ci in zip(tkeys, partials):
        r = rng.randrange(tpk.n2)
        a = pow(pow(c, 4, tpk.n2), r, tpk.n2)
        b = pow(tpk.v, r, tpk.n2)
        e = zkp_hash(a, b, c ** 4, ci ** 2)
        z = r + e * delta * k.share
        zkps.append({"id": k.id, "r": r, "a": a, "b": b, "e": e, "z": z})
    out["threshold"] = {
        "bits": 64, "l": 5, "t": 3, "n": tpk.n, "g": tpk.g, "h": tpk.h,
        "k": tpk.k, "v": tpk.v, "vi": list(tpk.vi),
        "shares": [{"id": k.id, "share": k.share} for k in tkeys],
        "m": msg, "r": r_enc, "c": c, "partials": partials, "zkps": zkps}

    # ---- DDLEQ transcript (128-bit key, 2 proofs x 4 instances) -----------
    sk, pk = keygen(128, rng)
    dd_rng = random.Random(0xDD1E0)
    msd = [rng.randrange(pk.n) for _ in range(2)]
    ct1 = nested_encrypt(pk, msd, dd_rng)
    ct2, a_l, b_l = hom.nested_randomize(pk, ct1, dd_rng)
    proof = prove(sk, ct1, ct2, a_l, b_l, 4, dd_rng)
    assert verify(pk, ct1, ct2, proof) == [True, True]
    pv = proof.to_ints()
    # independent check of the verify relation per instance (ddleq.go:140-152)
    c1v = decode_batch(ct1.c)
    c2v = decode_batch(ct2.c)
    n, n2, n3 = pk.n, pk.n2, pk.n3
    for i in range(2):
        for j in range(4):
            x, y = pv["x"][i][j], pv["y"][i][j]
            alph, e, f = pv["alpha"][i][j], pv["e"][i][j], pv["f"][i][j]
            from paillier_tpu.ops.oracle import oracle_bit
            chal = oracle_bit(c1v[i], c2v[i], x, y, alph)
            base = c2v[i] if chal else c1v[i]
            lhs = pow(base, pow(e, n, n2), n3) * pow(f, n2, n3) % n3
            assert lhs == alph, "ddleq transcript inconsistent"
    out["ddleq"] = {
        "bits": 128, "n": pk.n, "g": pk.g, "h": pk.h, "k": pk.k,
        "lam": sk.lam, "p": sk.p, "q": sk.q,
        "m": msd, "a": [int(v) for v in a_l], "b": [int(v) for v in b_l],
        "ct1": c1v, "ct2": c2v, "secpar": 4,
        "proof": {f: pv[f] for f in ("x", "y", "alpha", "e", "f")}}

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "vectors.json")
    with open(path, "w") as fh:
        json.dump(out, fh)
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
