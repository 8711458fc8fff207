"""The port's benchmark suite against phe_tpu/benchmarks.py, on the CPU.

bench_key_size at a 256-bit key emits rows with phe_tpu's keys plus the
device they ran on ("cpu" here, so no CPU row can pass for a card
number), and its speed_of_light comes from the cost model of the engine
that ran: the RNS models by default, the limb-engine models with
rns_state patched to None (the package has no knob). bench_mem reports
the bytes the port holds per ciphertext, int64 limbs: 8 L. bench_scaling
waits for the parallel/ port and says so. The fixed keys are the
repository's.
"""

import json

import pytest
import torch

from phe_tpu import benchmarks as jbench
from phe_tpu import profiling as jprof

from phe_tpu_torch import batch as tbatch
from phe_tpu_torch import bench, benchmarks, profiling
from __graft_entry__ import _P, _Q

OPS = ["keygen", "encrypt", "decrypt", "add_enc_enc", "add_enc_scalar",
       "add_enc_one", "mul_enc_scalar", "sum_batch"]


@pytest.fixture(scope="module")
def phe_tpu_rows():
    rows = []
    jbench.bench_key_size(256, 4, runs=1, emit=rows.append)
    return [json.loads(r) for r in rows]


def _port_rows(engine, monkeypatch):
    if engine == "limb":
        monkeypatch.setattr(tbatch.PublicDeviceContext, "rns_state",
                            lambda self: None)
        monkeypatch.setattr(tbatch.PrivateDeviceContext, "rns_state",
                            lambda self: None)
    rows = []
    results = benchmarks.bench_key_size(256, 8, runs=1, emit=rows.append,
                                        device="cpu")
    return results, [json.loads(r) for r in rows]


@pytest.mark.parametrize("engine", ["rns", "limb"])
def test_bench_key_size_rows(phe_tpu_rows, monkeypatch, engine):
    results, rows = _port_rows(engine, monkeypatch)
    assert [r["metric"] for r in rows] == OPS
    assert [r["metric"] for r in phe_tpu_rows] == OPS
    for mine, theirs in zip(rows, phe_tpu_rows):
        assert set(mine) == set(theirs) | {"device"}
        assert mine["device"] == "cpu"
        assert mine["keysize"] == 256 and mine["batch"] == 8
    # speed_of_light from the model of the engine that ran.
    st = engine == "rns"
    for op, key in (("encrypt", "encrypt"), ("decrypt", "decrypt"),
                    ("add_enc_enc", "add"), ("mul_enc_scalar", "mul")):
        value = results[op]["value"]
        sol = results[op]["speed_of_light"]
        k_pub, k_half, L, Lp = 24, 24, 40, 24
        model = {
            "encrypt": profiling.rns_encrypt_cost(256, k_pub, 5) if st
            else profiling.encrypt_cost(256, L, 5),
            "decrypt": profiling.rns_decrypt_cost(256, k_half, 5) if st
            else profiling.decrypt_cost(256, Lp, 5),
            "add": profiling.mont_mul_cost(L),
            "mul": profiling.rns_vec_modexp_cost(64, k_pub, 4) if st
            else profiling.modexp_cost(64, L),
        }[key]
        assert sol == profiling.report(key, value, model)[
            "speed_of_light_fraction"]


def test_op_costs_follow_the_engine(monkeypatch):
    pub, priv = benchmarks.fixed_key(2048)
    costs = benchmarks.op_costs(pub, priv, "cpu")
    assert costs["encrypt"] == jprof.rns_encrypt_cost(2048, 304, 5)
    assert costs["decrypt"] == jprof.rns_decrypt_cost(2048, 152, 5)
    assert costs["mul"] == jprof.rns_vec_modexp_cost(64, 304, 4)
    assert costs["add"] == jprof.mont_mul_cost(296)
    monkeypatch.setattr(tbatch.PublicDeviceContext, "rns_state",
                        lambda self: None)
    monkeypatch.setattr(tbatch.PrivateDeviceContext, "rns_state",
                        lambda self: None)
    pub, priv = benchmarks.fixed_key(2048)
    costs = benchmarks.op_costs(pub, priv, "cpu")
    assert costs["encrypt"] == jprof.encrypt_cost(2048, 296, 5)
    assert costs["decrypt"] == jprof.decrypt_cost(2048, 152, 5)
    assert costs["mul"] == jprof.modexp_cost(64, 296)


def test_bench_mem_reports_int64_limbs():
    rows = []
    out = benchmarks.bench_mem(keysize=128, test_size=8, step=4,
                               emit=rows.append, device="cpu")
    rows = [json.loads(r) for r in rows]
    L = 24  # limbs of a 256-bit n^2
    assert out == {"device_bytes_per_ciphertext": 8 * L}
    assert rows[0]["metric"] == "device_bytes_per_ciphertext"
    assert rows[0]["value"] == 8 * L and rows[0]["device"] == "cpu"
    assert [r["held"] for r in rows[1:]] == [4, 8]
    assert all(r["device"] == "cpu" for r in rows)


def test_scaling_and_card_entry_points_refuse(monkeypatch):
    with pytest.raises(NotImplementedError, match="parallel"):
        benchmarks.bench_scaling()
    with pytest.raises(NotImplementedError, match="parallel"):
        benchmarks.main(["--key-sizes", "256", "--scaling"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmarks.main(["--key-sizes", "256"])
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main()


def test_fixed_keys():
    pub, priv = benchmarks.fixed_key(2048)
    assert (priv.p, priv.q) == (min(_P, _Q), max(_P, _Q))
    pub, priv = benchmarks.fixed_key(8192)
    assert pub.n.bit_length() == 8192 and priv.p.bit_length() == 4096
    with pytest.raises(ValueError, match="fixed keys"):
        benchmarks.fixed_key(1024)
