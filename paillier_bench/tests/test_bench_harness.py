"""The harness on the CPU: sound runs are correct, the controls and the
faults of the timed path are not, new cells come as files alone, and no
run may load jax or phe_tpu.

Each run drives the program (phe_tpu_torch on its plain PyTorch versions)
through the harness's own path with the look for a card skipped; the
faults are planted underneath, in the program's entry points.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from paillier_bench import leastwork, run
from paillier_bench.tests.conftest import BENCH, REPO, run_small


@pytest.mark.parametrize("seed", [2**31 + 77, -(2**40) - 3])
def test_sound_run_is_correct(tree, seed):
    result = run_small(tree, "fl", seed=seed)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert {m["unit"] for m in result["metrics"].values()} >= {"values/s",
                                                              "s"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("control,number", [
    ("float32", "plain_wrong"),
    ("no_obfuscation", "unblinded"),
])
def test_control_is_not_correct(tree, control, number):
    result = run_small(tree, "fl", control=control)
    assert not result["correct"]
    assert result["checks"][number]["value"] > 0


def _fault_fl(monkeypatch, fault):
    from phe_tpu_torch.batch import EncryptedBatch
    from phe_tpu_torch.models import federated

    real = federated.aggregate_encrypted_gradients
    if fault == "unchanged":  # the aggregate is a client's state, unsummed
        monkeypatch.setattr(federated, "aggregate_encrypted_gradients",
                            lambda batches, mesh=None: batches[0])
    elif fault == "half":  # half the clients, scaled to the whole
        def half(batches, mesh=None):
            part = real(batches[: len(batches) // 2])
            return part.mul_scalars([2] * len(part))

        monkeypatch.setattr(federated, "aggregate_encrypted_gradients", half)
    else:
        _alter_decrypt(monkeypatch, EncryptedBatch)


def _alter_decrypt(monkeypatch, cls):
    """One answer altered where it is produced: the first decrypted
    value of every call."""
    real = cls.decrypt

    def altered(self, private_key, Encoding=None):
        out = real(self, private_key, Encoding)
        out[0] = out[0] * 1.5 + 1e-3
        return out

    monkeypatch.setattr(cls, "decrypt", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_of_the_timed_path_is_not_correct(tree, monkeypatch, fault):
    _fault_fl(monkeypatch, fault)
    result = run_small(tree, "fl")
    assert not result["correct"], result["checks"]


def test_traced_run_reports_its_per_layer_metrics(tree, monkeypatch):
    monkeypatch.setattr(run, "TRACE_SECONDS", 0.0)
    monkeypatch.setattr(run, "TRACE_MIN", 1)
    result = run_small(tree, "fl", trace=True, seconds=0.0)
    assert result["correct"], result["checks"]
    # On the CPU no operation runs on a device: the readers of device
    # time find nothing, nothing launches a kernel, and nothing captures.
    assert result["metrics"] == {
        "window_captures.fl": {"value": 0.0, "unit": "calls"}}
    assert result["device"]["busy_s"] == 0.0
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_cell_config_mix_and_metric_added_as_files_alone(tree):
    """A configuration, a mix and a metric that the harness has never
    seen, added as files and entries: the harness finds all three."""
    root = tree
    bench = os.path.join(root, "paillier_bench")
    with open(os.path.join(bench, "configs", "small.json")) as f:
        config = json.load(f)
    config.update(name="other", clients_per_round=2, coordinates_per_call=4)
    with open(os.path.join(bench, "configs", "other.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench, "traffic", "fl_small.json")) as f:
        mix = json.load(f)
    mix.update(gradient_sigma=3.0)
    with open(os.path.join(bench, "traffic", "fl_pair.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench, "metrics", "steps_done.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.steps))\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append(dict(spec["configs"][0], name="other",
                                file="paillier_bench/configs/other.json"))
    spec["workloads"].append(dict(spec["workloads"][0], name="pair",
                                  config="other", traffic="fl_pair"))
    spec["end_to_end"].append({"name": "steps_done", "unit": "steps",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["pair"]})
    for m in spec["end_to_end"]:
        if m["name"] == "fl_values_per_s":
            m["workloads"].append("pair")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    result = run_small(root, "pair")
    assert result["correct"], result["checks"]
    assert result["metrics"]["steps_done"]["value"] == result["attempted"]
    assert "fl_values_per_s" in result["metrics"]


def test_least_work_is_a_function_of_sizes_alone(tree, monkeypatch):
    """The same steps count the same least work whichever engine and
    REDC body the program would run, and the count scales with sizes."""
    from paillier_bench.protocols import fl_aggregate

    spec = run.Spec(tree)
    counts = []
    for engine, mxu in (("auto", "1"), ("limb", "1"), ("rns", "0")):
        monkeypatch.setenv("PHE_TPU_TORCH_ENGINE", engine)
        monkeypatch.setenv("PHE_TPU_TORCH_MXU", mxu)
        fl = fl_aggregate.Mix(spec.config("small"), spec.traffic("fl_small"),
                              5, "cpu", None)
        counts.append([fl.least(i) for i in range(4)])
    assert counts[0] == counts[1] == counts[2]
    ops, nbytes = leastwork.fl_step(2048, 1024, 1024, 10, 1024,
                                    np.ones((10, 1024), int))
    ops2, _ = leastwork.fl_step(2048, 1024, 1024, 10, 2048,
                                np.ones((10, 2048), int))
    assert ops2 == 2 * ops and nbytes > 0
    assert leastwork.modexp_ops(4096, [1, 1]) == 0
    assert leastwork.modexp_ops(4096, 3) == 2 * leastwork.square_ops(4096)
    assert leastwork.square_ops(4096) < leastwork.product_ops(4096)


def test_window_captures_count_calls_that_replayed_no_graph():
    reader = run.Spec(REPO).reader("window_captures.fl")
    r = run.Run("values", 1.0)
    assert reader(r) is None  # no window, nothing to read
    r.steps = [(0, 0.0, 1.0, 8)]
    assert reader(r) == 0.0
    r.new_keys, r.new_graphs = 1, 1  # a shape first called, then captured
    assert reader(r) == 2.0


def test_warm_up_takes_every_call_width_of_a_round(monkeypatch):
    """The deployment's round is 12 calls of 16,384 coordinates and one
    of 2,602; the warm-up runs both widths, at the round's clients."""
    from paillier_bench.protocols import fl_aggregate

    spec = run.Spec(REPO)
    mix = fl_aggregate.Mix(spec.config("fedavg_2nn-2048"),
                           spec.traffic("fl_fedavg_2nn"), 1, "cpu", None)
    assert mix.calls == 13
    assert [mix.width(i) for i in (0, 11, 12, 13)] == [16384] * 2 + [
        2602, 16384]
    seen = []
    monkeypatch.setattr(mix, "_encrypt", lambda g: [g[0], g[1]])
    monkeypatch.setattr(mix, "_aggregate",
                        lambda batches: seen.append(
                            (len(batches), len(batches[0]))))
    mix.warm()
    assert seen == [(10, 2602)] * 2 + [(10, 16384)] * 2


def test_import_check_compares_whole_top_level_names(monkeypatch):
    base = run.forbidden_modules()
    for name in ("phe_tpu_torch.batch", "jaxfoo", "phe_tpu_torchx",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == base
    for name in ("phe_tpu.batch", "jaxlib", "flax.core", "jax"):
        monkeypatch.setitem(sys.modules, name, object())
    assert set(run.forbidden_modules()) >= {"phe_tpu", "jaxlib", "flax",
                                            "jax"}


def test_no_card_means_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "fl_2nn-2048", "--seed", "1", "--seconds",
                  "1", "--trace", "0"])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's own
    files, a run fails without a result, card or none: the program is
    not there (a phe_tpu_torch found elsewhere is refused)."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "paillier_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, %r); "
            "from paillier_bench import run; "
            "print(run.run_cell(%r, 'fl_2nn-2048', 1, 1, False, 'cpu'))"
            % (str(tmp_path), str(tmp_path)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    proc = subprocess.run(
        [sys.executable, "paillier_bench/run.py", "--workload",
         "fl_2nn-2048", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["fl_2nn-2048", "fl_2nn-3072"])
def test_cell_runs_correct_on_the_card(cell):
    """A short run of a cell on the card (python -m pytest
    paillier_bench/tests -m cuda, on a machine with one)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    proc = subprocess.run(
        [sys.executable, "paillier_bench/run.py", "--workload", cell,
         "--seed", str(2**31 + 5), "--seconds", "2", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
