"""The program's spans and graph-cache counter, as the harness sees them.

On synthetic profiler events: the program's spans, and the copies the
profiler lays of them on the device's timeline, leave every reading of
the accepted harness as it was; ``hostspans`` reads the host encode and
decode layer's self time and the device's idle time under it. On stub
graphs: ``programs.calls`` counts the re-warm and re-capture that follow
an eviction inside a window, where ``window_captures`` reads 0.
"""

import types

import pytest
import torch

from paillier_bench import hostspans, run
from paillier_bench.devicetrace import profiler_events, reduce
from phe_tpu_torch import profiling, programs

HARNESS = {"fl.encrypt", "fl.decrypt"}
CPU = torch.device("cpu")


class _Event:
    """The fields of a profiler event that profiler_events reads."""

    def __init__(self, name, device, start, end, annotation=False):
        self.name = name
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)
        self.is_user_annotation = annotation
        self.time_range = types.SimpleNamespace(start=start, end=end)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


# One client's encrypt and a decrypt, in microseconds: host spans, the
# harness's spans, the device's operations.
HARNESS_EVENTS = [
    _Event("fl.encrypt", False, 0, 1000, True),
    _Event("fl.encrypt", True, 250, 880, True),
    _Event("rns_ladder_kernel", True, 250, 880),
    _Event("fl.decrypt", False, 1000, 1400, True),
    _Event("decrypt_kernel", True, 1020, 1090),
    _Event("Memcpy DtoH", True, 1120, 1140),
]
PROGRAM_EVENTS = [
    _Event("batch.encode", False, 0, 100, True),
    _Event("batch.pack", False, 100, 150, True),
    _Event("batch.draw_r", False, 150, 200, True),
    _Event("program._encrypt_rns", False, 200, 900, True),
    _Event("program._encrypt_rns", True, 250, 880, True),
    _Event("program._decrypt_compact_rns", False, 1000, 1100, True),
    _Event("program._decrypt_compact_rns", True, 1020, 1090, True),
    _Event("batch.decode", False, 1100, 1400, True),
    _Event("batch.readback", False, 1110, 1150, True),
    _Event("batch.readback", True, 1120, 1140, True),
]
NAMES = HARNESS | {e.name for e in PROGRAM_EVENTS}


def test_program_spans_leave_the_accepted_readings_as_they_were():
    spec = run.Spec(run.ROOT)
    readings = []
    for events in (HARNESS_EVENTS, HARNESS_EVENTS + PROGRAM_EVENTS):
        busy_s, ops, gaps = reduce(
            profiler_events(_Prof(events), HARNESS), HARNESS)
        r = run.Run("values", 1.0)
        r.steps = [(0, 0.0, 1.0, 8)]
        r.trace = run.Trace(steps=1, window_s=0.0014, busy_s=busy_s,
                            least_s=0.0002, launches={"rns_ladder": 3})
        values = {m: spec.reader(m)(r) for m in (
            "crypto_roofline.fl", "device_idle.fl", "launches_per_step.fl",
            "window_captures.fl")}
        readings.append((busy_s, ops, gaps, values))
    assert readings[0] == readings[1]
    busy_s, ops, gaps, _ = readings[0]
    assert busy_s == pytest.approx(720e-6)
    assert [name for name, _ in ops] == [
        "rns_ladder_kernel", "decrypt_kernel", "Memcpy DtoH"]


def test_host_busy_is_the_host_spans_self_time():
    events = profiler_events(_Prof(HARNESS_EVENTS + PROGRAM_EVENTS), NAMES)
    # encode 100, pack 50, draw_r 50, decode 300 less its read-back's 40.
    assert hostspans.host_busy_s(events, NAMES, profiling.HOST_SPANS) == (
        pytest.approx(460e-6))
    # Overlapping children count once.
    events.append(("batch.readback", False, 1130, 1160))
    assert hostspans.host_busy_s(events, NAMES, profiling.HOST_SPANS) == (
        pytest.approx(450e-6))


def test_host_wait_is_the_idle_time_under_host_spans():
    events = profiler_events(_Prof(HARNESS_EVENTS + PROGRAM_EVENTS), NAMES)
    _, _, gaps = reduce(events, NAMES)
    # The gaps' midpoints: 125 in batch.pack (the innermost span open),
    # 950 in fl.encrypt alone, 1105 and 1270 in batch.decode.
    assert dict(gaps) == pytest.approx({
        "batch.pack": 250e-6, "fl.encrypt": 140e-6, "batch.decode": 290e-6})
    assert hostspans.host_wait_s(events, NAMES, profiling.HOST_SPANS) == (
        pytest.approx(540e-6))
    # Without the program's names the same gaps fall to the harness.
    _, _, gaps = reduce(events, HARNESS)
    assert hostspans.host_wait_s(events, HARNESS, profiling.HOST_SPANS) == 0
    assert dict(gaps) == pytest.approx(
        {"fl.encrypt": 390e-6, "fl.decrypt": 290e-6})


class _Graphs:
    def warm_up(self, dev, fn):
        return fn()

    def capture(self, dev, fn):
        return object(), fn()

    def replay(self, graph):
        pass


def _plus_one(x):
    return x + 1


def test_calls_see_the_re_warm_that_window_captures_misses(monkeypatch):
    for k in programs.calls:
        monkeypatch.setitem(programs.calls, k, 0)
    monkeypatch.setattr(programs, "evictions", programs.evictions)
    prog = programs.device_program(_plus_one)
    x = torch.ones(4, dtype=torch.int64)

    def call():
        prog.run(CPU, {"x": x}, _Graphs())

    call()
    call()  # set-up: warmed and captured
    graphs0, evictions0 = run._graph_state()
    calls0 = dict(programs.calls)
    programs.evict(CPU)  # inside the window
    for _ in range(3):
        call()
    graphs1, evictions1 = run._graph_state()
    r = run.Run("values", 1.0)
    r.steps = [(0, 0.0, 1.0, 8)]
    r.new_keys = len(graphs1.keys() - graphs0.keys())
    r.new_graphs = sum(g and not graphs0.get(k, False)
                       for k, g in graphs1.items())
    assert run.Spec(run.ROOT).reader("window_captures.fl")(r) == 0.0
    moved = {k: programs.calls[k] - calls0[k] for k in calls0}
    assert moved == {"warm_up": 1, "capture": 1, "replay": 2}
    assert evictions1 - evictions0 == 1
