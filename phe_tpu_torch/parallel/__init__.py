"""Multi-process parallelism for ciphertext batches, on torch.distributed.

The port of phe_tpu.parallel. The reference is single-process (its
"multi-party" protocols pass Python objects in one process,
examples/federated_learning_with_encryption.py:213-225); phe_tpu shards
``uint32[B, V, L]`` limb tensors over a JAX device mesh. Here one process
drives each device (SPMD: every rank calls with the same full tensor), a
``BatchMesh`` lays the ranks out as (dp, mp), and the encrypted-aggregation
reduce, whose combine step is a modular multiplication mod n^2
(phe/paillier.py:705-719), not an addition, so all_reduce's SUM does not
apply, is a local Montgomery-product tree and a send/receive ring over dp
with one Montgomery product a hop. NCCL carries it between cards, gloo on
the CPU.
"""

from phe_tpu_torch.parallel.mesh import (
    BatchMesh,
    batch_mesh,
    initialize_distributed,
    reduce_mul_ring,
    sharded_batch,
    tree_reduce_mul,
)
from phe_tpu_torch.parallel.aggregate import (
    allreduce_mul_mont,
    encrypted_sum_sharded,
)

__all__ = [
    "BatchMesh",
    "batch_mesh",
    "initialize_distributed",
    "sharded_batch",
    "tree_reduce_mul",
    "reduce_mul_ring",
    "allreduce_mul_mont",
    "encrypted_sum_sharded",
]
