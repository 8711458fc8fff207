"""One rank of a gloo world running phe_tpu_torch.parallel on the CPU.

Usage: python torch_parallel_worker.py <rank> <world> <init_file> <out_dir>

Every rank builds the same pinned-r batches of a fixed 256-bit key from
seeds, runs the mesh's reductions over the world (dp = world, and
(dp, mp) = (world / 2, 2) for the vector case), and writes what it got as
JSON to <out_dir>/rank<rank>.json: ciphertext ints (canonical, so ranks
and packages compare exactly) and exponents. The test compares them with
phe_tpu's single-device results. Imports neither jax nor phe_tpu.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import phe_tpu_torch as pt  # noqa: E402
from phe_tpu_torch import benchmarks, parallel  # noqa: E402
from phe_tpu_torch.batch import EncryptedBatch  # noqa: E402
from phe_tpu_torch.models import aggregate_encrypted_gradients  # noqa: E402
from phe_tpu_torch.ops import montgomery as mg  # noqa: E402

# The 256-bit pair of tests/distributed_worker.py.
P = 307260150530527508970926394744437130671
Q = 246443548683535459572940433370278944997
SIZES = (1, 5, 8, 13)
MIXED = [1, 2.5, -0.125, 300, 4.75, -7, 1e-3]
CPU = torch.device("cpu")


def values(seed, count):
    rng = np.random.default_rng(seed)
    return [float(v) for v in rng.uniform(-100, 100, count).round(4)]


def pinned_r(pub, seed, count):
    rng = np.random.default_rng(seed)
    return [1 + int.from_bytes(rng.bytes(40), "little") % (pub.n - 1)
            for _ in range(count)]


def batch_of(pub, vals, seed):
    return EncryptedBatch.encrypt(pub, vals, r_values=pinned_r(pub, seed,
                                                                len(vals)),
                                  device=CPU)


def record(batch):
    return {"ints": [str(c) for c in batch.ciphertext_ints(be_secure=False)],
            "exponents": [int(e) for e in batch.exponents]}


def main():
    rank, world, init_file, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                       sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)  # the ranks share the host's cores
    parallel.initialize_distributed("file://" + init_file, world, rank,
                                    device="cpu")
    pub = pt.PaillierPublicKey(P * Q)
    priv = pt.PaillierPrivateKey(pub, P, Q)
    dc = pub.device_context(CPU)
    out = {"world": torch.distributed.get_world_size()}
    mesh = parallel.batch_mesh()
    out["mesh"] = [mesh.dp, mesh.mp, mesh.dp_rank, mesh.mp_rank]

    # encrypted_sum_sharded at every batch size, and at mixed exponents.
    for size in SIZES:
        batch = batch_of(pub, values(size, size), 100 + size)
        out["sum%d" % size] = record(parallel.encrypted_sum_sharded(batch,
                                                                     mesh))
    mixed = batch_of(pub, MIXED, 7)
    total = parallel.encrypted_sum_sharded(mixed, mesh)
    out["mixed"] = record(total)
    out["mixed_decrypted"] = total.decrypt(priv)

    # The ring alone: each rank's own row, multiplied round the ring.
    rows = batch_of(pub, values(50, world), 50).mont_logical
    ring = parallel.reduce_mul_ring(rows[rank], dc.ctx, mesh)
    out["ring"] = str(dc.export_ints(ring[None])[0])
    out["ring_limbs"] = mg.export_canonical(ring, dc.ctx).tolist()

    # Encrypted vectors [B, V, L] over (dp, mp) = (world / 2, 2).
    if world % 2 == 0:
        mesh2 = parallel.batch_mesh(mp=2)
        out["mesh2"] = [mesh2.dp, mesh2.mp, mesh2.dp_rank, mesh2.mp_rank]
        B, V = 5, 6
        grads = np.random.default_rng(11).integers(1, 1000, size=(B, V))
        flat = batch_of(pub, [int(v) for v in grads.reshape(-1)], 11)
        mont = flat.mont_logical.reshape(B, V, -1)
        vec = parallel.allreduce_mul_mont(mont, dc.ctx, mesh2)
        summed = EncryptedBatch(pub, vec, np.zeros(V, dtype=np.int64))
        out["vector"] = record(summed)
        out["vector_limbs"] = vec.tolist()

    # The FL aggregation with the mesh, and without it.
    clients = [batch_of(pub, values(200 + c, 6), 200 + c)
               for c in range(3)]
    clients[1] = clients[1].mul_scalars([1e-3] * 6)  # other exponents
    with_mesh = aggregate_encrypted_gradients(clients, mesh=mesh)
    without = aggregate_encrypted_gradients(clients)
    out["fl_mesh"] = record(with_mesh)
    out["fl_plain"] = record(without)

    # The scaling harness over the world.
    rows_out = []
    sweep = benchmarks.bench_scaling(keysize=128, batch=16, runs=1,
                                     emit=rows_out.append, device="cpu")
    out["scaling"] = {str(k): v for k, v in sweep.items()}
    out["scaling_rows"] = rows_out

    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    print("RANK_OK %d" % rank, flush=True)


if __name__ == "__main__":
    main()
