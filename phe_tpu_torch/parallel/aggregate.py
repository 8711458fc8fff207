"""Distributed encrypted aggregation: the FL gradient sum over ranks.

The port of phe_tpu/parallel/aggregate.py. Summing encrypted values is a
product of ciphertexts mod n^2, commutative and associative
(examples/federated_learning_with_encryption.py:122-133 does it as a
Python ring in one process). Each rank folds its dp shard of the batch axis
with a Montgomery-product tree, the partials go round the dp ring, and the
mp pieces of a vector axis are gathered.
"""

import numpy as np
import torch
import torch.distributed as dist

from phe_tpu_torch.ops import montgomery as mg
from phe_tpu_torch.parallel.mesh import (
    batch_mesh,
    reduce_mul_ring,
    sharded_batch,
    tree_reduce_mul,
)


def allreduce_mul_mont(mont, ctx, mesh, vector_axes=None):
    """Product over the batch axis of a [B, ..., L] Montgomery tensor.

    Every rank of the mesh calls with the same full tensor. B pads with
    Montgomery ones (ctx.one) to a multiple of dp; each rank folds its
    shard (and, with vector_axes > 0, its mp piece of the first inner
    axis), the partials ring over dp, and the mp pieces are all-gathered.
    Returns [..., L] on every rank, the same limbs everywhere: the product
    in canonical Montgomery form (value < M), whatever order each rank
    multiplied in.
    """
    if vector_axes is None:
        vector_axes = mont.ndim - 2
    pad = (-mont.shape[0]) % mesh.dp
    if pad:
        one = ctx.one.to(mont.dtype).expand((pad,) + tuple(mont.shape[1:]))
        mont = torch.cat([mont, one], dim=0)
    part = tree_reduce_mul(sharded_batch(mont, mesh, vector_axes), ctx)
    out = mg.export_canonical(reduce_mul_ring(part, ctx, mesh), ctx)
    if vector_axes > 0 and mesh.mp > 1:
        pieces = [torch.empty_like(out) for _ in range(mesh.mp)]
        dist.all_gather(pieces, out.contiguous(), group=mesh.mp_group)
        out = torch.cat(pieces, dim=0)
    return out


def encrypted_sum_sharded(batch, mesh=None):
    """Homomorphic sum of an EncryptedBatch over the mesh (size-1 result).

    Exponents align to the batch minimum on the device first (the
    reference's alignment rule, phe/paillier.py:664-669), then the
    ciphertext product reduces across the ranks. Every rank passes the
    same batch and gets the same sum.
    """
    from phe_tpu_torch.batch import EncryptedBatch

    if mesh is None:
        mesh = batch_mesh()
    target = int(batch.exponents.min())
    aligned = batch.decrease_exponent_to(target)
    # All Bp rows, as batch.sum() folds them: the bucket's padding rows
    # are encryptions of 0.
    mont = allreduce_mul_mont(aligned.mont, aligned._dc.ctx, mesh,
                              vector_axes=0)
    return EncryptedBatch(batch.public_key, mont[None], np.array([target]),
                          False)
