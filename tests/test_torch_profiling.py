"""The port's roofline accounting against phe_tpu/profiling.py, and its
spans.

Every cost model is number-for-number phe_tpu's, over a grid of key
sizes, limb counts, channel counts, windows and both Montgomery paths;
the bound and the report agree given the same peaks and device kind (both
modules' chip_peaks patched to one answer). chip_peaks reports the H100
row as measured only for an H100. Tolerance zero: the models are integer
counts and the same float expressions.

The spans (profiling.span) record only under a profiler session, and a
small federated round on the CPU emits the names of profiling.SPANS,
nested as the module's docstring says.
"""

import json

import numpy as np
import pytest
import torch

from phe_tpu import profiling as jprof

import phe_tpu_torch as pt
from phe_tpu_torch import profiling
from phe_tpu_torch.batch import EncryptedBatch
from phe_tpu_torch.models.federated import aggregate_encrypted_gradients

CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]
BITS = [64, 256, 1024, 2048, 4096, 8192]
LIMBS = [8, 40, 152, 296, 592, 1176]
KS = [8, 24, 152, 304, 624]
WINDOWS = [1, 4, 5, 6]


@pytest.fixture(scope="module")
def keys():
    """A 256-bit key pair whose CPU contexts are built (a first round
    outside any profiler), so that a trace holds only a round's work."""
    pub, priv = pt.generate_paillier_keypair(n_length=256)
    EncryptedBatch.encrypt(pub, [1.0, 2.0], device="cpu").decrypt(priv)
    return pub, priv


@pytest.mark.parametrize("mxu", [True, False])
def test_limb_engine_cost_models_equal_phe_tpus(mxu):
    for L in LIMBS:
        assert profiling.mont_mul_cost(L, mxu) == jprof.mont_mul_cost(L, mxu)
        for bits in BITS:
            for w in WINDOWS:
                assert (profiling.modexp_cost(bits, L, w, mxu)
                        == jprof.modexp_cost(bits, L, w, mxu))
                assert (profiling.encrypt_cost(bits, L, w, mxu)
                        == jprof.encrypt_cost(bits, L, w, mxu))
                assert (profiling.decrypt_cost(bits, L, w, mxu)
                        == jprof.decrypt_cost(bits, L, w, mxu))
    assert profiling.encrypt_cost(2048, 296) == jprof.encrypt_cost(2048, 296)


def test_rns_cost_models_equal_phe_tpus():
    for k in KS:
        assert profiling.rns_mont_mul_cost(k) == jprof.rns_mont_mul_cost(k)
        for bits in BITS:
            for w in WINDOWS:
                for name in ("rns_modexp_cost", "rns_vec_modexp_cost",
                             "rns_encrypt_cost", "rns_decrypt_cost"):
                    assert (getattr(profiling, name)(bits, k, w)
                            == getattr(jprof, name)(bits, k, w)), name


def test_bound_and_report_equal_phe_tpus(monkeypatch):
    peaks = (15.8677e12, 20.2965e12, 1979e12 / 2)
    answer = lambda device_kind=None: (peaks, "NVIDIA H100 80GB HBM3", False)
    monkeypatch.setattr(profiling, "chip_peaks", answer)
    monkeypatch.setattr(jprof, "chip_peaks", answer)
    costs = [profiling.encrypt_cost(2048, 296),
             profiling.rns_encrypt_cost(2048, 304, 5),
             profiling.rns_decrypt_cost(8192, 624, 5),
             profiling.rns_vec_modexp_cost(64, 304, 4),
             profiling.modexp_cost(64, 1176),
             profiling.mont_mul_cost(296, mxu=False)]
    for cost in costs:
        for rate in (1.0, 8140.4, 3.1e5, 1.2e7):
            assert (profiling.ideal_seconds_per_op(cost)
                    == jprof.ideal_seconds_per_op(cost))
            assert (profiling.ideal_seconds_per_op(cost, peaks)
                    == jprof.ideal_seconds_per_op(cost, peaks))
            mine = profiling.report("op", rate, cost)
            assert mine == jprof.report("op", rate, cost)
            assert json.loads(json.dumps(mine)) == mine


def test_chip_peaks_measured_only_for_an_h100(monkeypatch):
    peaks, kind, assumed = profiling.chip_peaks("NVIDIA H100 80GB HBM3")
    assert not assumed and kind == "NVIDIA H100 80GB HBM3"
    assert peaks[2] == 1979e12 / 2
    for other in ("cpu", "NVIDIA A100-SXM4-80GB", "TPU v5 lite"):
        got, kind, assumed = profiling.chip_peaks(other)
        assert assumed and got == peaks and kind == other
    # Without a card, the default kind is "cpu".
    monkeypatch.setattr(profiling.torch.cuda, "is_available", lambda: False)
    _, kind, assumed = profiling.chip_peaks()
    assert (kind, assumed) == ("cpu", True)


def test_timed_and_trace(tmp_path, keys):
    """profiling.trace() writes a chrome trace holding the program's
    spans, host and program, around a small encrypt."""
    pub, _ = keys
    with profiling.trace(str(tmp_path)) as prof:
        EncryptedBatch.encrypt(pub, [1.5, -2.0, 3.25], device="cpu")
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert prof is not None and "batch.encode" in names
    assert any(n.startswith("program.") for n in names if n)


def test_span_records_only_under_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function outside a profiler session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    # Off: one shared null context, whatever the name.
    assert profiling.span("batch.encode") is profiling.span("batch.pack")
    with profiling.span("batch.encode"):
        pass
    monkeypatch.undo()
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        with profiling.span("batch.encode"):
            pass
    assert [e.name for e in prof.events()
            if e.is_user_annotation] == ["batch.encode"]


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_a_round_emits_its_spans_nested_as_documented(tmp_path, keys):
    """Encrypt, aggregate and decrypt at a 256-bit key under
    profiling.trace(): every name its trace holds is in SPANS, each host
    span appears, batch.readback lies in batch.decode, and no host span
    holds a program call."""
    pub, priv = keys
    values = np.random.default_rng(5).normal(0.0, 0.01, (2, 4))
    with profiling.trace(str(tmp_path)):
        batches = [EncryptedBatch.encrypt(pub, row.tolist(), device="cpu")
                   for row in values]
        out = aggregate_encrypted_gradients(batches).decrypt(priv)
    assert out == pytest.approx(values.sum(axis=0), rel=1e-12)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"]
    names = {name for name, _, _ in spans}
    assert names <= profiling.SPANS
    assert profiling.HOST_SPANS | {"batch.readback"} <= names
    programs_ = [s for s in spans if s[0].startswith("program.")]
    assert programs_
    host = [s for s in spans if s[0] in profiling.HOST_SPANS]
    decodes = [s for s in spans if s[0] == "batch.decode"]
    for r in (s for s in spans if s[0] == "batch.readback"):
        assert any(_within(r, d) for d in decodes), r
    for h in host:
        assert not any(_within(p, h) for p in programs_), h
