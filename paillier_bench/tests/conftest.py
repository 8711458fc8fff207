"""Fixtures of the benchmark's CPU tests: a checkout-like tree in a
temporary directory, holding a BENCHMARK.json of a small cell at a
255-bit key and the data files it names. The harness runs there on the
CPU, with the program's plain PyTorch versions of its kernels."""

import json
import os
import shutil

import pytest

from paillier_bench import run

REPO = run.ROOT
BENCH = os.path.join(REPO, "paillier_bench")
# Two fixed 128-bit primes: keys small enough for the CPU.
P = "0x80000000000000000000000001234581"
Q = "0xc00000000000000000000000089abcd1"
ENV = ("PHE_TPU_TORCH_CACHE_DIR", "PHE_TPU_TORCH_NATIVE_DIR",
       "PHE_TPU_TORCH_ENGINE", "PHE_TPU_TORCH_MXU")


def _load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def _dump(obj, root, *parts):
    path = os.path.join(root, "paillier_bench", *parts)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def small_tree(root, fl_clients=4):
    """A tree with cell "fl" of the repository's mix, cut to a few
    coordinates on config "small"; returns BENCHMARK.json's dict."""
    shutil.copytree(os.path.join(BENCH, "metrics"),
                    os.path.join(root, "paillier_bench", "metrics"))
    config = dict(_load("configs", "fedavg_2nn-2048.json"), name="small",
                  key_bits=255, p=P, q=Q, clients_per_round=fl_clients,
                  parameters=20, coordinates_per_call=8)
    _dump(config, root, "configs", "small.json")
    _dump(_load("traffic", "fl_fedavg_2nn.json"), root, "traffic",
          "fl_small.json")
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"] = [dict(spec["configs"][0], name="small",
                            file="paillier_bench/configs/small.json")]
    spec["workloads"] = [dict(spec["workloads"][0], name="fl",
                              config="small", traffic="fl_small")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["fl"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return spec


@pytest.fixture
def tree(tmp_path, monkeypatch):
    from paillier_bench.protocols import fl_aggregate

    for name in ENV:  # the harness sets them; put them back afterwards
        monkeypatch.delenv(name, raising=False)
    # Every step kept, and a few ciphertexts of each read back.
    monkeypatch.setattr(fl_aggregate, "KEEP_EVERY", 1)
    monkeypatch.setattr(fl_aggregate, "CIPHERTEXTS", 4)
    small_tree(str(tmp_path))
    return str(tmp_path)


def run_small(root, cell, seed=2**31 + 77, seconds=0.5, trace=False,
              control=None):
    return run.run_cell(root, cell, seed, seconds, trace, "cpu", control)
