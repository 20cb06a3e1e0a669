"""Serialization, fixed-point encoding, and CLI smoke tests."""

import math
import random

import pytest

from paillier_tpu.core.decrypt import Decryptor
from paillier_tpu.core.encrypt import Encryptor
from paillier_tpu.core.keys import LEVEL_ONE, LEVEL_TWO, decode_batch
from paillier_tpu.ops.encoding import (decode_fixed_point, decode_signed,
                                       encode_fixed_point, encode_signed)
from paillier_tpu.ops.serialize import (ciphertext_from_bytes,
                                        ciphertext_to_bytes, key_from_json,
                                        public_key_to_json)
from paillier_tpu.threshold.keygen import generate_threshold_keys


class TestSerialization:
    def test_ciphertext_roundtrip(self, keypair_128, rng):
        # analogue of paillier_test.go:140-156
        sk, pk = keypair_128
        enc = Encryptor(pk, LEVEL_ONE, rng=rng)
        ms = [rng.randrange(pk.n) for _ in range(8)]
        ct = enc.encrypt(ms)
        data = ciphertext_to_bytes(ct)
        ct2 = ciphertext_from_bytes(data)
        assert ct2.level == ct.level and ct2.method == ct.method
        assert decode_batch(ct2.c) == decode_batch(ct.c)
        dec = Decryptor(sk, LEVEL_ONE)
        assert dec.decrypt(ct2) == ms

    def test_empty_data_rejected(self):
        with pytest.raises(ValueError):
            ciphertext_from_bytes(b"")
        with pytest.raises(ValueError):
            ciphertext_from_bytes(b"JUNKJUNKJUNKJUNKJUNK")

    def test_key_roundtrip(self, keypair_128):
        sk, pk = keypair_128
        pk2 = key_from_json(public_key_to_json(pk))
        assert (pk2.n, pk2.g, pk2.h, pk2.k) == (pk.n, pk.g, pk.h, pk.k)
        sk2 = key_from_json(public_key_to_json(sk))
        assert (sk2.lam, sk2.p, sk2.q) == (sk.lam, sk.p, sk.q)

    def test_threshold_key_roundtrip(self, rng):
        keys = generate_threshold_keys(32, 3, 2, rng)
        k = keys[0]
        k2 = key_from_json(public_key_to_json(k))
        assert (k2.id, k2.share, k2.vi, k2.v, k2.l, k2.t) == (
            k.id, k.share, k.vi, k.v, k.l, k.t)
        tpk = k.public()
        tpk2 = key_from_json(public_key_to_json(tpk))
        assert tpk2.vi == tpk.vi and not hasattr(tpk2, "share") or \
            type(tpk2).__name__ == "ThresholdPublicKey"


class TestFixedPoint:
    def test_encode_matches_reference_semantics(self):
        # plaintext.go:10-18: floor(a * 2^prec)
        assert encode_fixed_point(1.5, 4) == 24
        assert encode_fixed_point(0.1, 8) == int(0.1 * 256)
        assert encode_fixed_point("0.1", 8) == 25  # floor(25.6)

    def test_roundtrip(self):
        for v in (0.0, 1.25, 3.14159, 100.5):
            enc = encode_fixed_point(v, 32)
            assert abs(decode_fixed_point(enc, 32) - v) < 2 ** -31

    def test_signed(self):
        n = 1000003
        assert decode_signed(encode_signed(-5, n), n) == -5
        assert decode_signed(encode_signed(7, n), n) == 7
        with pytest.raises(ValueError):
            encode_signed(n, n)

    def test_homomorphic_fixed_point_mean(self, keypair_128, rng):
        sk, pk = keypair_128
        enc = Encryptor(pk, LEVEL_ONE, rng=rng)
        dec = Decryptor(sk, LEVEL_ONE)
        from paillier_tpu.core import homomorphic as hom
        from paillier_tpu.core.keys import Ciphertext
        vals = [1.5, 2.25, 3.75, 0.5]
        prec = 16
        ct = enc.encrypt([encode_fixed_point(v, prec) for v in vals])
        agg = hom.aggregate(pk, ct, axis=0)
        total = dec.decrypt(Ciphertext(c=agg.c[None], level=LEVEL_ONE))[0]
        assert decode_fixed_point(total, prec) == sum(vals)


class TestCli:
    def test_demo(self, capsys):
        from paillier_tpu.cli import main
        main(["--seed", "3", "demo", "--bits", "64"])
        out = capsys.readouterr().out
        assert "homomorphic sum     -> 1010" in out
        assert "ok" in out

    def test_threshold(self, capsys):
        from paillier_tpu.cli import main
        main(["--seed", "3", "threshold", "--bits", "32", "--servers", "3",
              "--threshold", "2"])
        out = capsys.readouterr().out
        assert "[1, 0, 1, 1, 0]" in out
        assert "ok" in out


class TestRoofline:
    def test_model_math(self):
        from paillier_tpu.ops.profiling import (PEAKS, RooflineModel,
                                                sliding_mults)
        # 2048-bit exponent, window 6: ~2048 squarings + ~292 window
        # multiplies + 32-entry odd table + entry/exit
        assert sliding_mults(2048, 6) == 2048 + 292 + 32 + 2
        m = RooflineModel(mod_bits=4096, exp_bits=2048, k=320, window=6,
                          peaks=PEAKS["NVIDIA H100 80GB HBM3"])
        assert m.macs_per_mult == 8 * 320 * 320
        # 320 output columns pad to 384: 2 extensions x [2k]x[2*384]
        assert m.macs_per_mult_padded == 2 * 640 * 768
        assert m.bytes_per_mult == 2 * 640 * 4
        assert m.bound() == min(m.int8_bound(), m.memory_bound())
        # H100 int8 ceiling for 2048-bit encryption: 1,979 TOP/s over
        # 2 * 8k^2 * 2374 ops per element ~= 509k enc/s (sanity anchor)
        assert 500_000 < m.int8_bound(padded=False) < 520_000
        r = m.report(50_000)
        assert "measured" in r and "int8" in r and "H100" in r

    def test_encryption_roofline_probe(self):
        from paillier_tpu.ops.profiling import PEAKS, encryption_roofline
        m = encryption_roofline(256, peaks=PEAKS["NVIDIA H100 80GB HBM3"])
        assert m.mod_bits == 512 and m.exp_bits == 256
        assert m.k >= 64 and m.k % 64 == 0

    def test_h100_peaks_row(self):
        from paillier_tpu.ops.profiling import device_peaks
        p = device_peaks("NVIDIA H100 80GB HBM3")
        assert (p.int8_tops, p.hbm_gbps) == (1979.0, 3350.0)
        assert "data sheet" in p.source

    @pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
    def test_unknown_device_kind_raises(self, kind):
        from paillier_tpu.ops.profiling import RooflineModel, device_peaks
        with pytest.raises(ValueError, match="no published peaks"):
            device_peaks(kind)
        # the CPU this suite runs on has no row either: no silent default
        with pytest.raises(ValueError, match="no published peaks"):
            RooflineModel(mod_bits=512, exp_bits=256, k=64)
