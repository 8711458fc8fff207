"""The port's parallel layer (torch.distributed) against phe_tpu's.

Worlds of 2 and 4 gloo processes on the CPU (tests/torch_parallel_worker.py,
each rank its own subprocess with its own timeout, joined through a
file:// store under tmp_path) run encrypted_sum_sharded at B = 1, 5, 8
and 13 and at mixed exponents, the ring on the Montgomery product alone,
encrypted vectors over (dp, mp) = (world / 2, 2), the FL aggregation with
and without a mesh, and the scaling harness. Every rank's results are
held equal to each other and, ciphertext for ciphertext, to phe_tpu's on
the same pinned inputs: its single-device EncryptedBatch.sum(), its
tree_reduce_mul, its allreduce_mul_mont on the virtual 8-device CPU mesh
and its FL aggregation. The 256-bit key of tests/distributed_worker.py;
tolerance zero throughout: all exact integer arithmetic.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import phe_tpu
from phe_tpu import batch as jbatch
from phe_tpu.models.federated import (
    aggregate_encrypted_gradients as j_aggregate,
)
from phe_tpu.parallel import batch_mesh as j_batch_mesh
from phe_tpu.parallel.aggregate import allreduce_mul_mont as j_allreduce
from phe_tpu.parallel.mesh import tree_reduce_mul as j_tree_reduce_mul

import phe_tpu_torch as pt
from phe_tpu_torch import parallel
from phe_tpu_torch.models import aggregate_encrypted_gradients
from tests import torch_parallel_worker as worker

WORKER = worker.__file__
WORLDS = (2, 4)
RANK_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _force_rns(monkeypatch):
    monkeypatch.setenv("PHE_TPU_ENGINE", "rns")
    monkeypatch.setenv("PHE_TPU_RNS_KERNEL", "xla")


def _run_world(world, tmp):
    """Start every rank, wait for each with its own timeout, and return
    the ranks' JSON records."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    init = os.path.join(tmp, "init")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), init, tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        )
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "RANK_OK" in out, (
            "rank %d of %d failed:\n%s" % (r, world, out))
    records = []
    for r in range(world):
        with open(os.path.join(tmp, "rank%d.json" % r)) as f:
            records.append(json.load(f))
    return records


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: _run_world(w, str(tmp_path_factory.mktemp("world%d" % w)))
            for w in WORLDS}


@pytest.fixture(scope="module")
def keys():
    jpub = phe_tpu.PaillierPublicKey(worker.P * worker.Q)
    jpriv = phe_tpu.PaillierPrivateKey(jpub, worker.P, worker.Q)
    pub = pt.PaillierPublicKey(worker.P * worker.Q)
    return jpub, jpriv, pub, pt.PaillierPrivateKey(pub, worker.P, worker.Q)


def _jbatch(keys, vals, seed):
    jpub, _, pub, _ = keys
    return jbatch.EncryptedBatch.encrypt(
        jpub, vals, r_values=worker.pinned_r(pub, seed, len(vals)))


def _ints(record):
    return [int(c) for c in record["ints"]], record["exponents"]


def _same_on_every_rank(records, key):
    for r, rec in enumerate(records[1:], 1):
        assert rec[key] == records[0][key], "rank %d differs on %s" % (r, key)
    return records[0][key]


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_lay_out_as_phe_tpu_mesh(worlds, world):
    records = worlds[world]
    assert [rec["world"] for rec in records] == [world] * world
    # Row-major, as phe_tpu's devices.reshape(dp, mp).
    assert [rec["mesh"] for rec in records] == [
        [world, 1, r, 0] for r in range(world)]
    assert [rec["mesh2"] for rec in records] == [
        [world // 2, 2, r // 2, r % 2] for r in range(world)]


@pytest.mark.parametrize("size", worker.SIZES)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_sum_equals_phe_tpu_single_device_sum(worlds, keys, world,
                                                      size):
    got = _same_on_every_rank(worlds[world], "sum%d" % size)
    want = _jbatch(keys, worker.values(size, size), 100 + size).sum()
    assert _ints(got) == (want.ciphertext_ints(be_secure=False),
                          [int(e) for e in want.exponents])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_sum_at_mixed_exponents(worlds, keys, world):
    got = _same_on_every_rank(worlds[world], "mixed")
    want = _jbatch(keys, worker.MIXED, 7).sum()
    assert _ints(got) == (want.ciphertext_ints(be_secure=False),
                          [int(e) for e in want.exponents])
    assert _same_on_every_rank(worlds[world], "mixed_decrypted") == \
        want.decrypt(keys[1])


@pytest.mark.parametrize("world", WORLDS)
def test_ring_on_mont_mul_equals_phe_tpu_tree(worlds, keys, world):
    jpub = keys[0]
    got = int(_same_on_every_rank(worlds[world], "ring"))
    # Every rank returns the same limbs, not only the same value.
    _same_on_every_rank(worlds[world], "ring_limbs")
    rows = _jbatch(keys, worker.values(50, world), 50)
    dc = jpub.device_context()
    product = j_tree_reduce_mul(rows.mont_logical, dc.ctx)
    assert got == dc.export_ints(product[None])[0]
    product = 1
    for c in rows.ciphertext_ints(be_secure=False):
        product = product * c % jpub.nsquare
    assert got == product


@pytest.mark.parametrize("world", WORLDS)
def test_vector_aggregation_over_dp_and_mp(worlds, keys, world):
    # The FL layout: [B, V, L] with B over dp and V over mp = 2, against
    # phe_tpu's allreduce_mul_mont on a (2, 2) mesh of its CPU devices.
    jpub, jpriv = keys[0], keys[1]
    records = worlds[world]
    got = _same_on_every_rank(records, "vector")
    _same_on_every_rank(records, "vector_limbs")
    B, V = 5, 6
    grads = np.random.default_rng(11).integers(1, 1000, size=(B, V))
    flat = _jbatch(keys, [int(v) for v in grads.reshape(-1)], 11)
    dc = jpub.device_context()
    mont = flat.mont_logical.reshape(B, V, -1)
    out = j_allreduce(mont, dc.ctx, j_batch_mesh(n_devices=4, mp=2))
    want = jbatch.EncryptedBatch(jpub, out, np.zeros(V, dtype=np.int64),
                                 False)
    assert _ints(got)[0] == want.ciphertext_ints(be_secure=False)
    assert want.decrypt(jpriv) == list(grads.sum(axis=0))


@pytest.mark.parametrize("world", WORLDS)
def test_fl_aggregation_with_mesh_equals_without(worlds, keys, world):
    records = worlds[world]
    with_mesh = _same_on_every_rank(records, "fl_mesh")
    assert with_mesh == _same_on_every_rank(records, "fl_plain")
    clients = [_jbatch(keys, worker.values(200 + c, 6), 200 + c)
               for c in range(3)]
    clients[1] = clients[1].mul_scalars([1e-3] * 6)
    want = j_aggregate(clients)
    assert _ints(with_mesh) == (want.ciphertext_ints(be_secure=False),
                                [int(e) for e in want.exponents])


@pytest.mark.parametrize("world", WORLDS)
def test_scaling_harness_over_the_world(worlds, world):
    records = worlds[world]
    sweep = records[0]["scaling"]
    assert sorted(int(d) for d in sweep) == [d for d in (1, 2, 4)
                                             if d <= world]
    for row in sweep.values():
        assert row["elements_per_s"] > 0 and row["scaling_efficiency"] > 0
    assert sweep["1"]["scaling_efficiency"] == 1.0
    rows = [json.loads(line) for line in records[0]["scaling_rows"]]
    assert [r["devices"] for r in rows] == [int(d) for d in sweep]
    assert all(r["backend"] == "gloo" and r["world"] == world
               and r["device"] == "cpu" for r in rows)
    # Only rank 0 reports.
    assert all(rec["scaling"] == {} and rec["scaling_rows"] == []
               for rec in records[1:])


# -- a world of one: no process group ----------------------------------------


def test_world_of_one_without_a_process_group(keys):
    mesh = parallel.batch_mesh()
    assert (mesh.dp, mesh.mp, mesh.dp_rank, mesh.mp_rank) == (1, 1, 0, 0)
    assert mesh.member and mesh.dp_group is None and mesh.dp_ranks == (0,)
    with pytest.raises(ValueError, match="do not lay out"):
        parallel.batch_mesh(n_devices=2)
    with pytest.raises(ValueError, match="do not lay out"):
        parallel.batch_mesh(mp=2)


@pytest.mark.parametrize("size", worker.SIZES)
def test_world_of_one_sum_equals_batch_sum(keys, size):
    pub = keys[2]
    batch = worker.batch_of(pub, worker.values(size, size), 100 + size)
    got = parallel.encrypted_sum_sharded(batch)
    want = batch.sum()
    assert got.ciphertext_ints(False) == want.ciphertext_ints(False)
    assert list(got.exponents) == list(want.exponents)
    assert got.decrypt(keys[3]) == want.decrypt(keys[3])


def test_world_of_one_fl_aggregation_and_ring(keys):
    pub = keys[2]
    clients = [worker.batch_of(pub, worker.values(300 + c, 5), 300 + c)
               for c in range(3)]
    mesh = parallel.batch_mesh()
    got = aggregate_encrypted_gradients(clients, mesh=mesh)
    want = aggregate_encrypted_gradients(clients)
    assert got.ciphertext_ints(False) == want.ciphertext_ints(False)
    row = clients[0].mont_logical[0]
    assert parallel.reduce_mul_ring(row, pub.device_context("cpu").ctx,
                                    mesh) is row


def test_sharded_batch_splits_and_refuses_uneven_axes():
    mesh = parallel.BatchMesh(dp=2, mp=2, dp_rank=1, mp_rank=0,
                              dp_ranks=(0, 2), dp_group=None, mp_group=None)
    x = torch.arange(4 * 6 * 3).reshape(4, 6, 3)
    assert torch.equal(parallel.sharded_batch(x, mesh), x[2:4])
    assert torch.equal(parallel.sharded_batch(x, mesh, vector_axes=1),
                       x[2:4, 0:3])
    with pytest.raises(ValueError, match="does not split over dp"):
        parallel.sharded_batch(x[:3], mesh)
    with pytest.raises(ValueError, match="does not split over mp"):
        parallel.sharded_batch(x[:, :5], mesh, vector_axes=1)
    outside = mesh._replace(dp_rank=-1, mp_rank=-1)
    assert not outside.member
    with pytest.raises(ValueError, match="outside the mesh"):
        parallel.sharded_batch(x, outside)
