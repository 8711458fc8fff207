"""Process meshes, a rank's shard of a ciphertext tensor, and the modmul ring.

Layout convention, as phe_tpu's: an encrypted tensor is ``[B, ..., L]``
Montgomery limbs, a leading batch axis (sharded over "dp"), optional inner
vector axes such as the gradient dimension of the FL example (the first
one sharded over "mp"), and the trailing limb axis L, never sharded (the
carries of Montgomery arithmetic run across limbs). Ranks lay out
row-major as phe_tpu's devices do in its mesh: rank = dp_index * mp +
mp_index. The one communicating operation is the aggregation reduce over
the batch axis: each rank folds its shard with a Montgomery-product tree,
then the partials go round the dp ring (reference semantics: encrypted add
== ciphertext product mod n^2, phe/paillier.py:705-719).
"""

from typing import NamedTuple

import torch
import torch.distributed as dist

from phe_tpu_torch import config
from phe_tpu_torch.batch import _tree_fold
from phe_tpu_torch.ops import montgomery as mg


class BatchMesh(NamedTuple):
    """This rank's place in a (dp, mp) layout of the first dp * mp ranks.

    dp_rank / mp_rank: its indices, -1 for a rank outside the mesh.
    dp_ranks: the global ranks of its dp ring, in ring order (ranks
      sharing its mp index). dp_group / mp_group: the process groups of
      its ring and of its mp row; None in a world of one process.
    """

    dp: int
    mp: int
    dp_rank: int
    mp_rank: int
    dp_ranks: tuple
    dp_group: object
    mp_group: object

    @property
    def member(self):
        return self.dp_rank >= 0


def initialize_distributed(init_method, world_size, rank, device=None):
    """Join the process group: NCCL for a CUDA device, gloo for the CPU.

    A thin wrapper over dist.init_process_group (phe_tpu's wraps
    jax.distributed.initialize). init_method: e.g. "tcp://localhost:<port>"
    or "file://<path>"; nothing on the machine names a cluster, so the
    caller gives the address, the world size and its rank. device: None
    for the card (CUDA device ``rank`` modulo the cards present), "cpu"
    for gloo. No-op if already initialized. Returns the device this rank
    runs on.
    """
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", rank % torch.cuda.device_count())
    dev = config.resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method, world_size=world_size, rank=rank,
        )
    return dev


def batch_mesh(n_devices=None, mp=1):
    """A (dp, mp) layout of the first n_devices ranks (default: all).

    dp shards the ciphertext batch axis; mp shards the first inner vector
    axis of encrypted vectors (e.g. the gradient dimension in federated
    aggregation). mp=1 gives pure batch data parallelism. Without a
    process group this is a world of one. With one, every rank of the
    world must call it, in the same order, as dist.new_group requires.
    """
    initialized = dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world or n % mp:
        raise ValueError("%s ranks of a world of %d do not lay out as "
                         "(dp, mp=%d)" % (n, world, mp))
    dp = n // mp
    member = rank < n
    dp_ranks = tuple(range(rank % mp, n, mp)) if member else ()
    dp_group = mp_group = None
    if initialized:
        for j in range(mp):
            group = dist.new_group(list(range(j, n, mp)))
            if member and j == rank % mp:
                dp_group = group
        for i in range(dp):
            group = dist.new_group(list(range(i * mp, (i + 1) * mp)))
            if member and i == rank // mp:
                mp_group = group
    return BatchMesh(dp, mp, rank // mp if member else -1,
                     rank % mp if member else -1, dp_ranks, dp_group,
                     mp_group)


def sharded_batch(mont, mesh, vector_axes=0):
    """This rank's shard of a [B, ..., L] limb tensor.

    B splits over dp; with vector_axes > 0 the first inner axis splits
    over mp too (further vector axes and the limb axis stay whole). Each
    split axis must divide evenly, as a JAX NamedSharding requires.
    """
    if not mesh.member:
        raise ValueError("this rank lies outside the mesh")
    B = mont.shape[0]
    if B % mesh.dp:
        raise ValueError("batch of %d does not split over dp = %d"
                         % (B, mesh.dp))
    rows = B // mesh.dp
    x = mont[mesh.dp_rank * rows : (mesh.dp_rank + 1) * rows]
    if vector_axes > 0:
        V = mont.shape[1]
        if V % mesh.mp:
            raise ValueError("vector axis of %d does not split over mp = %d"
                             % (V, mesh.mp))
        cols = V // mesh.mp
        x = x[:, mesh.mp_rank * cols : (mesh.mp_rank + 1) * cols]
    return x.contiguous()


def tree_reduce_mul(mont, ctx):
    """Montgomery-product fold over the leading axis: [B, ..., L] -> [..., L].

    The port's batch tree (batch._tree_fold): log depth, one Montgomery
    product launch a level, the combine step of homomorphic addition.
    """
    return _tree_fold(mont, ctx)[0]


def reduce_mul_ring(local, ctx, mesh):
    """All-reduce over the dp ring with Montgomery-product combine.

    local: [..., L] this rank's partial product. In n - 1 hops each rank
    sends its last received partial to the next rank of its ring, receives
    the previous rank's (dist.batch_isend_irecv) and multiplies it in: one
    Montgomery product a hop, as phe_tpu's ppermute ring does. Every rank
    ends with the product over the ring. A ring of one returns local.
    """
    n = mesh.dp
    if n == 1:
        return local
    i = mesh.dp_rank
    nxt, prev = mesh.dp_ranks[(i + 1) % n], mesh.dp_ranks[(i - 1) % n]
    L = ctx.num_limbs
    acc = local
    buf = local.contiguous()
    for _ in range(n - 1):
        recv = torch.empty_like(buf)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, buf, nxt, mesh.dp_group),
            dist.P2POp(dist.irecv, recv, prev, mesh.dp_group),
        ])
        for req in reqs:
            req.wait()
        acc = mg.mont_mul(acc.reshape(-1, L), recv.reshape(-1, L),
                          ctx).reshape(local.shape)
        buf = recv
    return acc
