"""The vertical LR mix on the CPU: a sound run is correct, the controls
are not, and the check counts each planted fault on the count it
targets. A cell "vfl" of the repository's mix, cut to 48 rows of 3 host
and 2 guest features at a 255-bit key, runs through the harness's own
path with the look for a card skipped."""

import json
import os

import numpy as np
import pytest

from paillier_bench.devicetrace import Tracer
from paillier_bench.protocols import vfl_hetero_lr
from paillier_bench.reference import hetero_lr as ref_lr
from paillier_bench.tests.conftest import ENV, P, Q, _dump, _load, run_small
from paillier_bench.tests.conftest import small_tree

SMALL = dict(key_bits=255, p=P, q=Q, rows=48, batch_rows=48,
             host_features=3, guest_features=2)


def _config():
    return dict(_load("configs", "hetero_lr_credit-2048.json"),
                name="vfl_small", **SMALL)


@pytest.fixture
def vfl_tree(tmp_path, monkeypatch):
    for name in ENV:  # the harness sets them; put them back afterwards
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(vfl_hetero_lr, "KEEP_EVERY", 1)
    monkeypatch.setattr(vfl_hetero_lr, "CIPHERTEXTS", 4)
    root = str(tmp_path)
    spec = small_tree(root)
    _dump(_config(), root, "configs", "vfl_small.json")
    _dump(_load("traffic", "vfl_hetero_lr.json"), root, "traffic",
          "vfl_small.json")
    spec["configs"].append(dict(spec["configs"][0], name="vfl_small",
                                file="paillier_bench/configs/vfl_small.json",
                                reduced=["loss"]))
    spec["workloads"].append(dict(spec["workloads"][0], name="vfl",
                                  config="vfl_small", traffic="vfl_small"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("vfl")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def test_sound_run_is_correct(vfl_tree):
    result = run_small(vfl_tree, "vfl", seed=2**33 + 5)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["metrics"]["fl_values_per_s"]["unit"] == "values/s"
    assert all(c["value"] == 0 for c in result["checks"].values())
    json.dumps(result)  # the line run.main prints


def test_traced_run_counts_its_least_work(vfl_tree, monkeypatch):
    from paillier_bench import run

    monkeypatch.setattr(run, "TRACE_SECONDS", 0.0)
    monkeypatch.setattr(run, "TRACE_MIN", 1)
    least = []
    real = vfl_hetero_lr.Mix.least
    monkeypatch.setattr(vfl_hetero_lr.Mix, "least",
                        lambda self, i: least.append(real(self, i))
                        or least[-1])
    result = run_small(vfl_tree, "vfl", trace=True, seconds=0.0)
    assert result["correct"], result["checks"]
    # On the CPU nothing runs on a device: only the captures are read.
    assert result["metrics"] == {
        "window_captures.fl": {"value": 0.0, "unit": "calls"}}
    assert least and all(type(ops) is int and ops > 0 and nbytes > 0
                         for ops, nbytes in least)
    json.dumps(result)


@pytest.mark.parametrize("control,number", [
    ("float32", "plain_wrong"),
    ("no_obfuscation", "unblinded"),
])
def test_control_is_not_correct(vfl_tree, control, number):
    result = run_small(vfl_tree, "vfl", control=control)
    assert not result["correct"]
    assert result["checks"][number]["value"] > 0


@pytest.fixture(scope="module")
def one_step():
    """A Mix after one kept step and its export."""
    traffic = _load("traffic", "vfl_hetero_lr.json")
    keep = vfl_hetero_lr.KEEP_EVERY
    vfl_hetero_lr.KEEP_EVERY = 1
    try:
        mix = vfl_hetero_lr.Mix(_config(), traffic, -(2**40) - 9, "cpu",
                                Tracer())
        mix.setup()
        mix.step(0, mix.prepare(0))
    finally:
        vfl_hetero_lr.KEEP_EVERY = keep
    mix.export()
    return mix


def _counts(mix):
    return {k: v for k, (v, _) in mix.check([0]).items()}


def test_check_is_clean_on_a_sound_step(one_step):
    assert _counts(one_step) == {"plain_wrong": 0, "cipher_wrong": 0,
                                 "unblinded": 0}
    # [[u_A]] and [[d]] sampled, and every masked coordinate.
    names = {name for name, _ in one_step.exported[0]}
    assert names == {"u", "d", "host", "guest"}


def _planted(mix, fault):
    outputs, exported = dict(mix.outputs), dict(mix.exported)
    masked, gradient = mix.outputs[0]
    sample = dict(mix.exported[0])
    if fault == "coordinate":
        mix.outputs[0] = (masked, [gradient[0] + 1e-3] + gradient[1:])
    elif fault == "unblinded":
        key, s = mix.key, mix.reference(0)
        j = next(j for name, j in sample if name == "u")
        plain = key.residue(int(s.u_mantissas[j]))
        sample["u", j] = ((1 + key.n * plain) % key.nsquare,
                          sample["u", j][1])
        mix.exported[0] = sample
    else:
        j = next(j for name, j in sample if name == "d")
        sample["d", j] = (sample["d", j][0], sample["d", j][1] - 1)
        mix.exported[0] = sample
    try:
        return _counts(mix)
    finally:
        mix.outputs, mix.exported = outputs, exported


@pytest.mark.parametrize("fault,number", [
    ("coordinate", "plain_wrong"),
    ("unblinded", "unblinded"),
    ("exponent", "cipher_wrong"),
])
def test_check_counts_a_planted_fault_once(one_step, fault, number):
    counts = _planted(one_step, fault)
    assert counts == {k: int(k == number) for k in counts}


def test_warm_reaches_every_width(one_step, monkeypatch):
    """The warm-up's parties make both grids of a step take each width,
    as matvec's schedules are bucketed."""
    from phe_tpu_torch import batch as tbatch

    widths = []
    real = tbatch._digits_on

    def spy(digits, device):
        if digits.ndim == 3:  # a matvec grid's [B, D, n_windows]
            widths.append(4 * digits.shape[-1])
        return real(digits, device)

    monkeypatch.setattr(tbatch, "_digits_on", spy)
    theta, masks = one_step.inputs(0, vfl_hetero_lr._WARM)
    nh = one_step.n_host
    for width in vfl_hetero_lr.WIDTHS:
        host, guest = one_step._warm_parties(width, theta)
        _, d_exps = ref_lr.residual(
            ref_lr.scores(host.X, theta[:nh]),
            ref_lr.guest_scalars(guest.X, theta[nh:], guest.y))
        for X in (host.X, guest.X):
            bits = vfl_hetero_lr.grid_bits(d_exps, X).max()
            assert vfl_hetero_lr._bucket(bits) == width
        del widths[:]
        one_step._train(host, guest, theta, masks)
        assert widths == [width, width]
    assert np.array_equal(guest.y, one_step.y)
