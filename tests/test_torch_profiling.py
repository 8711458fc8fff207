"""The port's roofline accounting against phe_tpu/profiling.py.

Every cost model is number-for-number phe_tpu's, over a grid of key
sizes, limb counts, channel counts, windows and both Montgomery paths;
the bound and the report agree given the same peaks and device kind (both
modules' chip_peaks patched to one answer). chip_peaks reports the H100
row as measured only for an H100. Tolerance zero: the models are integer
counts and the same float expressions.
"""

import json

import pytest

from phe_tpu import profiling as jprof

from phe_tpu_torch import profiling

BITS = [64, 256, 1024, 2048, 4096, 8192]
LIMBS = [8, 40, 152, 296, 592, 1176]
KS = [8, 24, 152, 304, 624]
WINDOWS = [1, 4, 5, 6]


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


def test_timed_and_trace(tmp_path):
    sink = []
    with profiling.timed("block", sink):
        sum(range(1000))
    assert [label for label, _ in sink] == ["block"] and sink[0][1] >= 0
    with profiling.trace(str(tmp_path)) as prof:
        sum(range(1000))
    assert prof is not None and (tmp_path / "trace.json").exists()
