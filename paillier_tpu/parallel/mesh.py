"""Device mesh and sharding helpers.

The framework's parallelism model (SURVEY.md section 2, "Parallelism &
distribution inventory"):

* batch axis  -> data parallelism: ciphertexts shard across chips; all
  kernels are elementwise over batch, so encryption/decryption/homomorphic
  ops need no collectives at all.
* server axis -> threshold decryption servers: partial decryptions
  combine via a modular-product all-reduce over the device interconnect
  (the distributed seam the reference leaves implicit at
  thresholdkey.go:149-161).

No NCCL/MPI translation: collectives are XLA collectives inside
``shard_map`` over a ``jax.sharding.Mesh``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"
SERVER_AXIS = "servers"


def make_mesh(n_devices: Optional[int] = None,
              *, servers: Optional[int] = None) -> Mesh:
    """1D batch mesh, or 2D (servers, batch) mesh when ``servers`` > 1.

    Defaults resolve through the unified Config (mesh_devices /
    mesh_servers), then to all visible devices on a 1D batch axis."""
    from ..config import get_config
    cfg = get_config()
    devs = jax.devices()
    n = n_devices or cfg.mesh_devices or len(devs)
    servers = servers if servers is not None else (cfg.mesh_servers or 1)
    devs = devs[:n]
    if servers > 1:
        if n % servers:
            raise ValueError(f"{n} devices not divisible into {servers} "
                             "server groups")
        arr = np.array(devs).reshape(servers, n // servers)
        return Mesh(arr, (SERVER_AXIS, BATCH_AXIS))
    return Mesh(np.array(devs), (BATCH_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard axis 0 (batch) of a [B, L] limb tensor."""
    return NamedSharding(mesh, P(BATCH_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(x, mesh: Mesh):
    """Place a [B, L] tensor with its batch axis sharded across the mesh."""
    return jax.device_put(x, batch_sharding(mesh))
