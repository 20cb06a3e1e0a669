"""Unified Config (paillier_tpu/config.py): resolution order
explicit arg > env var > Config field, consumed by the engine dispatch,
Encryptor/Decryptor, mesh builder and threshold generator."""

import dataclasses
import random

import pytest

from paillier_tpu.config import Config, get_config, set_config


@pytest.fixture(autouse=True)
def restore_config():
    old = get_config()
    yield
    set_config(old)


def _fresh(sk):
    sk = type(sk)(**{f.name: getattr(sk, f.name)
                     for f in dataclasses.fields(sk)})
    return sk, sk.public()


def test_force_rns_resolution(keypair_128, monkeypatch):
    from paillier_tpu.core.encrypt import Encryptor
    sk, _ = _fresh(keypair_128[0])
    set_config(Config(force_rns=True))
    assert Encryptor(sk.public()).engine == "rns"
    # env override beats config
    sk2, _ = _fresh(sk)
    set_config(Config(force_rns=None))
    monkeypatch.setenv("PAILLIER_TPU_FORCE_RNS", "1")
    assert sk2.device().use_rns()


def test_window_defaults(keypair_128):
    from paillier_tpu.core.decrypt import Decryptor
    from paillier_tpu.core.encrypt import Encryptor
    sk, pk = _fresh(keypair_128[0])
    set_config(Config(window=8))
    assert Encryptor(pk).window == 8
    assert Decryptor(sk).window == 8
    # explicit arg wins
    assert Encryptor(pk, window=4).window == 4


def test_engine_kind_env(monkeypatch):
    from paillier_tpu.bigint.engine import default_engine_kind
    set_config(Config(engine="rns"))
    assert default_engine_kind() == "rns"
    monkeypatch.setenv("PAILLIER_TPU_ENGINE", "rns2")
    assert default_engine_kind() == "rns2"


def test_mesh_defaults():
    from paillier_tpu.parallel.mesh import BATCH_AXIS, SERVER_AXIS, make_mesh
    set_config(Config(mesh_devices=4, mesh_servers=2))
    mesh = make_mesh()
    assert mesh.shape[SERVER_AXIS] == 2 and mesh.shape[BATCH_AXIS] == 2


def test_threshold_timeout_default():
    from paillier_tpu.threshold.keygen import ThresholdKeyGenerator
    set_config(Config(keygen_timeout=7.5))
    gen = ThresholdKeyGenerator(32, 3, 2, random.Random(1))
    assert gen.timeout == 7.5


def test_compile_cache_env_set(monkeypatch, tmp_path):
    from paillier_tpu.config import compile_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache_dir() == str(tmp_path)


def test_compile_cache_env_unset(monkeypatch):
    import os

    import paillier_tpu
    from paillier_tpu.config import compile_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(os.path.dirname(
        os.path.abspath(paillier_tpu.__file__)))
    assert compile_cache_dir() == os.path.join(checkout, ".jax_cache")


@pytest.mark.parametrize("bits", [512, 1024, 2048])
@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_use_rns_platform_decision(monkeypatch, platform, bits):
    """DeviceKey.use_rns is the package's one backend decision: the RNS
    engine on a non-CPU device for keys >= 1024 bits."""
    from types import SimpleNamespace

    import jax

    from paillier_tpu.core.keys import DeviceKey
    monkeypatch.delenv("PAILLIER_TPU_FORCE_RNS", raising=False)
    set_config(Config(force_rns=None))
    fake = SimpleNamespace(pk=SimpleNamespace(bits=bits))
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [SimpleNamespace(platform=platform)])
    got = DeviceKey.use_rns(fake)
    monkeypatch.undo()
    assert got == (platform == "gpu" and bits >= 1024)
