"""The issue-rate calibration's timing, old against new: the mul and add
chains at K = 4,000 and 32,000 timed by CUDA events around 8 back-to-back
launches (the old phe_tpu_torch.microbench timing), and as the fastest of
8 launches each between its own events behind a lead of device spin
(microbench._events_s), of a float matmul, or of none; with the host as
it is and slowed by a 60 us busy-wait a launch. Each cell prints K =
4,000 ms, K = 32,000 ms and their ratio, three times.

Run on the card:  python3 calib_timing.py
"""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np
import torch
from phe_tpu_torch import microbench as mb
from phe_tpu_torch.ops import cuda_microbench as cm

torch.backends.cuda.matmul.allow_tf32 = False
x = torch.as_tensor(np.random.default_rng(1).integers(
    1, 1 << 14, (mb.R, mb.TB), dtype=np.int32), device="cuda")
a = torch.randn(4096, 4096, device="cuda")

def old(fn, n=8):
    s = torch.cuda.Event(enable_timing=True); e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n): fn()
    e.record(); torch.cuda.synchronize()
    return s.elapsed_time(e) / n

def each(lead):
    def t(fn, n=8):
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(n)]
        lead()
        for s, e in ev:
            s.record(); fn(); e.record()
        torch.cuda.synchronize()
        return min(s.elapsed_time(e) for s, e in ev)
    return t

def slow(fn):
    def g():
        t = time.perf_counter()
        while time.perf_counter() - t < 60e-6: pass
        return fn()
    return g

ways = {"old": old, "spin": lambda fn: 1e3 * mb._events_s(fn, 8),
        "matmul": each(lambda: torch.mm(a, a)), "none": each(lambda: None)}
for body in ("mul", "add"):
    for K in (4000, 32000):
        cm.issue_chain(x, body, K)
    torch.cuda.synchronize()
    for host in ("fast", "slow"):
        for name, way in ways.items():
            rs = []
            for rep in range(3):
                lo = way((slow if host == "slow" else (lambda f: f))(lambda: cm.issue_chain(x, body, 4000)))
                hi = way((slow if host == "slow" else (lambda f: f))(lambda: cm.issue_chain(x, body, 32000)))
                rs.append("%.4f %.4f %.2fx" % (lo, hi, hi / lo))
            print("%-4s host=%s %-6s %s" % (body, host, name, " | ".join(rs)), flush=True)
