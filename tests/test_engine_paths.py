"""Coverage for the accelerator code paths on CPU: PAILLIER_TPU_FORCE_RNS
routes encryption, CRT decryption (limbmm Toeplitz matmul kernel),
aggregation and const-mult through the RNS engine + limbmm plans that
auto-selection picks only on an accelerator (the XLA programs are the
same on every backend)."""

import random

import pytest


@pytest.fixture()
def force_rns(monkeypatch):
    monkeypatch.setenv("PAILLIER_TPU_FORCE_RNS", "1")


def test_rns_enc_dec_roundtrip_with_limbmm_crt(force_rns, keypair_256, rng):
    from paillier_tpu.core import homomorphic as hom
    from paillier_tpu.core.decrypt import Decryptor
    from paillier_tpu.core.encrypt import Encryptor
    from paillier_tpu.core.keys import LEVEL_ONE, Ciphertext
    sk, pk = keypair_256
    # fresh device key so the cached jit entries don't leak across the
    # forced-RNS boundary
    sk = type(sk)(**{f.name: getattr(sk, f.name)
                     for f in __import__("dataclasses").fields(sk)})
    pk = sk.public()
    enc = Encryptor(pk, LEVEL_ONE, rng=rng, engine="rns")
    dec = Decryptor(sk, LEVEL_ONE, crt=True, engine="rns")
    vals = [rng.randrange(pk.n) for _ in range(6)] + [0, 1, pk.n - 1]
    ct = enc.encrypt(vals)
    assert dec.decrypt(ct) == vals

    agg = hom.aggregate(pk, Ciphertext(c=ct.c[:4], level=LEVEL_ONE), axis=0)
    total = dec.decrypt(Ciphertext(c=agg.c[None], level=LEVEL_ONE))[0]
    assert total == sum(vals[:4]) % pk.n

    cm = hom.const_mult(pk, Ciphertext(c=ct.c[:4], level=LEVEL_ONE), 12345)
    assert dec.decrypt(cm) == [(12345 * v) % pk.n for v in vals[:4]]


def _fresh_keypair(sk):
    import dataclasses
    sk = type(sk)(**{f.name: getattr(sk, f.name)
                     for f in dataclasses.fields(sk)})
    return sk, sk.public()


def test_force_rns_respected_by_auto_dispatch(force_rns, keypair_256):
    """Decryptor's "auto" must honor PAILLIER_TPU_FORCE_RNS via
    DeviceKey.use_rns."""
    from paillier_tpu.core.decrypt import Decryptor
    from paillier_tpu.core.encrypt import Encryptor
    from paillier_tpu.core.keys import LEVEL_ONE
    sk, pk = _fresh_keypair(keypair_256[0])
    assert Decryptor(sk, LEVEL_ONE).engine == "rns"
    assert Decryptor(sk, LEVEL_ONE, crt=True).engine == "rns"
    assert Encryptor(pk, LEVEL_ONE).engine == "rns"


def test_rns_threshold_combine_tree(force_rns, rng):
    """The residue-space combine products (RNS tree + cprime) are
    bit-identical to the limb path: full (3,5)-threshold roundtrip with
    the engine forced on (covers _combine_products' Rns2 branch)."""
    import random
    from paillier_tpu.core.encrypt import Encryptor
    from paillier_tpu.core.keys import LEVEL_ONE
    from paillier_tpu.threshold.decrypt import combine, partial_decrypt_all
    from paillier_tpu.threshold.keygen import generate_threshold_keys
    r = random.Random(0x7E57)
    keys = generate_threshold_keys(64, 5, 3, r)
    tpk = keys[0].public()
    enc = Encryptor(tpk, LEVEL_ONE, rng=r)
    ms = [r.randrange(tpk.n) for _ in range(5)] + [0, 1]
    ct = enc.encrypt(ms)
    shares = partial_decrypt_all([keys[0], keys[2], keys[3]], ct)
    assert combine(tpk, shares) == ms


def test_rns_generic_decrypt_level1(force_rns, keypair_256, rng):
    """decrypt_kernel_rns (generic non-CRT path) on the RNS engine."""
    from paillier_tpu.core.decrypt import Decryptor
    from paillier_tpu.core.encrypt import Encryptor
    from paillier_tpu.core.keys import LEVEL_ONE
    sk, pk = _fresh_keypair(keypair_256[0])
    enc = Encryptor(pk, LEVEL_ONE, rng=rng, engine="rns")
    dec = Decryptor(sk, LEVEL_ONE, crt=False, engine="rns")
    vals = [rng.randrange(pk.n) for _ in range(4)] + [0, pk.n - 1]
    assert dec.decrypt(enc.encrypt(vals)) == vals


def test_rns_level2_roundtrip(force_rns, keypair_256, rng):
    """Level-2 (Damgard-Jurik s=2) encrypt + generic decrypt through the
    RNS engine at n^3 width."""
    from paillier_tpu.core.decrypt import Decryptor
    from paillier_tpu.core.encrypt import Encryptor
    from paillier_tpu.core.keys import LEVEL_TWO
    sk, pk = _fresh_keypair(keypair_256[0])
    enc = Encryptor(pk, LEVEL_TWO, rng=rng, engine="rns")
    dec = Decryptor(sk, LEVEL_TWO, engine="rns")
    n2 = pk.n * pk.n
    vals = [rng.randrange(n2) for _ in range(3)] + [0, n2 - 1]
    assert dec.decrypt(enc.encrypt(vals)) == vals


@pytest.mark.slow
def test_rns_level2_roundtrip_1024bit_192limbs(force_rns, rng):
    """Production-width coverage (SURVEY hard part #1):
    a 1024-bit key at level 2 runs the RNS engine at n^3 width =
    3072 bits = 192 limbs — the widest shape the framework uses per key
    bit (2048-bit keys hit the same code at 384 limbs on hardware)."""
    from paillier_tpu.core.decrypt import Decryptor
    from paillier_tpu.core.encrypt import Encryptor
    from paillier_tpu.core.keygen import keygen
    from paillier_tpu.core.keys import LEVEL_TWO
    sk, pk = keygen(1024, random.Random(0xB16))
    assert pk.device().limbs_for_level(LEVEL_TWO) == 192
    enc = Encryptor(pk, LEVEL_TWO, rng=rng, engine="rns")
    dec = Decryptor(sk, LEVEL_TWO, engine="rns")
    n2 = pk.n * pk.n
    vals = [rng.randrange(n2) for _ in range(2)] + [0, n2 - 1]
    assert dec.decrypt(enc.encrypt(vals)) == vals


# fixed 4096-bit key material (host.random_prime(2048, 3 mod 4, seed
# 0x4096)) so the slow test below skips keygen cost
_P4096 = 0xf5fc3a0d6fde6bbdaf8057c9a8eb12ae68dd100e502da994ffd54729d0140c6d00d7e55505f90f04cac05718d4a9e6e5fbf25f5504d4b57ac0dedbec44d5b7affa095848d4ed676aed0ffd4050f8203837422fda1897503e98a08d64fcf83332b55c9270a575ee167c2b8ce7bb0523d69be044f98d7b9d6c5a0af5211e146a7a94fcb744f1c9cd95aa3402bfc00e707cf1be1a165f5d6feb1ebc4a8d81323b9cf94eda334d624a3634c3827cb2dd49e5c67f23176bd3395e191d286c656e2ca24a1171aecd1c5af62276fcf5e7279a31281c09851b7b7238bff4a5aabb46279c4a30d253bf51e13363eba0055dd9d63fc39522781d8a8c7e0d2f3a0f3cbbad0b
_Q4096 = 0xcc9f13af6ae200a79bfcee76a080c7c8fbfe6476b3f48e458753ac3aac8e596156616879ca126ae5406dd3486b856f637450b57b5eba4da5cfd9e09c5e4bb67c19f0f0318f13de3f320c87d04d98da2b6ccdc6204056d87ca03e971e06e17602730f65ce1a10dff000efb96b2dd006c4a3e9f5d2f1cd6002b08b477a956f5c902eb42f56fa75cacdaadecc172ab5716b3a4b2f44545165cf3cb5f69966e9958e03a009773f142018b55ff6c57c3067b65c773e3d9d592a054604d46b7ee05e31486383148a697d1548f63bbaf7a9f71686d2d4a0f43c82ada8ae07ecdd0398c2bf61da743e6655165a006592a074520224d4c50c666d4602f39c930b4ab27be7


@pytest.mark.slow
def test_rns_roundtrip_4096bit(force_rns, rng):
    """SURVEY §5 long-axis top width: a 4096-bit key on
    the RNS engine — level-1 ops run mod n^2 = 8192 bits, k >= 640
    channels per base, exercising the wide-spec overflow guard and the
    Rns2Spec invariants at production-maximum width."""
    from paillier_tpu.core.decrypt import Decryptor
    from paillier_tpu.core.encrypt import Encryptor
    from paillier_tpu.core.keys import LEVEL_ONE, SecretKey
    p, q = _P4096, _Q4096
    n = p * q
    assert n.bit_length() == 4096
    sk = SecretKey(n=n, g=n + 1, h=4, k=1 << 2048, bits=4096,
                   lam=(p - 1) * (q - 1), p=p, q=q)
    pk = sk.public()
    eng = pk.device().rns(1)
    assert eng.spec.k >= 640               # wide path engaged
    enc = Encryptor(pk, LEVEL_ONE, rng=rng, engine="rns")
    dec = Decryptor(sk, LEVEL_ONE, crt=True, engine="rns")
    vals = [rng.randrange(n), 0, n - 1]
    assert dec.decrypt(enc.encrypt(vals)) == vals
