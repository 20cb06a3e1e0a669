"""paillier_tpu — a batched Paillier / Damgard-Jurik homomorphic
encryption framework in JAX (jit / shard_map).

Capability-equivalent to the Go reference library (sachaservan/paillier)
but redesigned for accelerators: all hot modular arithmetic runs as batched
limb-vector kernels on device, with the ciphertext batch as the SIMD axis
and jax.sharding meshes for multi-chip scale-out.

Quick start::

    import paillier_tpu as ptpu
    sk, pk = ptpu.keygen(2048)
    enc = ptpu.Encryptor(pk)
    dec = ptpu.Decryptor(sk, crt=True)
    ct = enc.encrypt([1, 2, 3])
    total = ptpu.homomorphic.aggregate(pk, ct)
"""

from .bigint import host, montgomery, vpu
from .config import Config, get_config, set_config
from .core import homomorphic
from .core.decrypt import Decryptor, decrypt_nested_layer, nested_decrypt
from .core.encrypt import Encryptor, nested_encrypt
from .core.keygen import keygen
from .core.keys import (ALTERNATIVE, DEFAULT_LEVEL, LEVEL_ONE, LEVEL_TWO,
                        MIXED, REGULAR, Ciphertext, DeviceKey, PublicKey,
                        SecretKey, decode_batch, encode_batch)
from .ops import encoding, oracle, serialize
from .ops.encoding import (decode_fixed_point, decode_signed,
                           encode_fixed_point, encode_signed)
from .ops.serialize import (ciphertext_from_bytes, ciphertext_to_bytes,
                            key_from_json, public_key_to_json)
from .parallel import collective, mesh
from .parallel.collective import distributed_combine, sharded_aggregate
from .parallel.mesh import make_mesh, shard_batch
from .threshold.decrypt import (combine, combine_ints, partial_decrypt,
                                partial_decrypt_int)
from .threshold.keygen import ThresholdKeyGenerator, generate_threshold_keys
from .threshold.keys import (PartialDecryption, PartialDecryptionZKP,
                             ThresholdPublicKey, ThresholdSecretKey)
from .threshold.safe_prime import generate_safe_prime, is_safe_prime
from .threshold.zkp import (combine_with_zkp, partial_decrypt_with_zkp,
                            verify_decryption, verify_proof)
from .zk.ddleq import DDLEQProof
from .zk.ddleq import prove as prove_ddleq
from .zk.ddleq import verify as verify_ddleq

__version__ = "0.1.0"
