"""Unified runtime configuration (SURVEY §5 "config/flag system" row).

The reference hardcodes its few knobs (concurrencyLevel=4, timeout=120s,
thresholdkey_generator.go:89-90) and takes the rest as function args.
This framework has genuinely tunable machinery — engine selection,
ladder window sizes, mesh shape — so one documented dataclass owns the
defaults, with environment-variable
overrides for deployment and a programmatic ``set_config`` for tests.

Resolution order everywhere: explicit function argument > environment
variable > ``Config`` field.  The env vars (kept for backwards
compatibility with earlier deployments):

    PAILLIER_TPU_ENGINE     engine kind (rns2 | rns)
    PAILLIER_TPU_FORCE_RNS  "1" forces the RNS engine on any backend
    PAILLIER_TPU_NO_NATIVE  non-empty disables the native GMP runtime

JAX_COMPILATION_CACHE_DIR, when set, is the only persistent compile cache
(see :func:`compile_cache_dir`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Config:
    """Framework-wide tunables.

    engine:        modexp engine kind: "rns2" (int8 Cox-Rower,
                   default), "rns" (bf16 Cox-Rower v1).
    force_rns:     None = auto (RNS on accelerators for keys >= 1024
                   bits; limb Montgomery otherwise).  True/False pins it.
    use_native:    None = auto-detect the native GMP runtime; False
                   disables it (pure-Python host math).
    window:        fixed-window ladder digit width (bits) for
                   per-element exponents.
    sliding_window: window for the shared-exponent sliding-window
                   odd-power ladder (the r^(n^s) / c^lambda hot paths).
    mesh_devices:  devices for parallel.mesh.make_mesh(); None = all.
    mesh_servers:  threshold server-axis rows for 2D meshes; None = 1D.
    keygen_timeout: safe-prime search timeout in seconds (the
                   reference's 120 s, thresholdkey_generator.go:90).
    """

    engine: str = "rns2"
    force_rns: Optional[bool] = None
    use_native: Optional[bool] = None
    window: int = 4
    sliding_window: int = 6
    mesh_devices: Optional[int] = None
    mesh_servers: Optional[int] = None
    keygen_timeout: float = 120.0


_config = Config()


def get_config() -> Config:
    return _config


def set_config(cfg: Config) -> None:
    """Replace the global config (tests / embedding applications)."""
    global _config
    _config = cfg


def engine_kind() -> str:
    """Engine kind: env override > config."""
    return os.environ.get("PAILLIER_TPU_ENGINE", _config.engine)


def force_rns() -> Optional[bool]:
    """Forced-RNS setting: env override > config (None = auto)."""
    if os.environ.get("PAILLIER_TPU_FORCE_RNS") == "1":
        return True
    return _config.force_rns


def native_enabled() -> bool:
    """Whether the native GMP runtime may be used: env kill-switch >
    config (None/True = allowed; actual availability is still probed by
    paillier_tpu.native.available())."""
    if os.environ.get("PAILLIER_TPU_NO_NATIVE"):
        return False
    return _config.use_native is not False


def compile_cache_dir() -> str:
    """Persistent compile-cache directory: ``$JAX_COMPILATION_CACHE_DIR``
    when set, else ``.jax_cache`` in the checkout holding this package."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


def use_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`.

    Called by the entry-point scripts (bench.py, chip_smoke.py); importing
    the package never touches the cache.  Returns the directory."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
