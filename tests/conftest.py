"""Test configuration: force a CPU backend with 8 virtual devices so the
multi-chip sharding paths can be exercised without accelerator hardware."""

import os

# Unit tests always run on the virtual 8-device CPU mesh, whatever the
# environment selects; jax may already be imported, so update the live
# config too.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: DISABLED for the test suite.  XLA's CPU
# backend has segfaulted inside executable (de)serialization for some of
# this suite's executables — in the cache writer
# (put_executable_and_time -> executable.serialize(), test_vectors) and
# in the cache reader (get_executable_and_time, test_threshold) — so no
# scoping of write thresholds makes the suite reliably complete.  Suites
# recompile each run.
jax.config.update("jax_enable_compilation_cache", False)

import random

import pytest


@pytest.fixture(scope="session")
def rng():
    return random.Random(0xC0FFEE)


@pytest.fixture(scope="session")
def keypair_128(rng):
    from paillier_tpu.core.keygen import keygen
    return keygen(128, rng)


@pytest.fixture(scope="session")
def keypair_256(rng):
    from paillier_tpu.core.keygen import keygen
    return keygen(256, rng)
