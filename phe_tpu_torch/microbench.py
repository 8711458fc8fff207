"""Int32 issue-rate calibration of the roofline, on the card.

The port of scripts/vpu_microbench.py. The kernel of csrc/microbench.cu
(ops/cuda_microbench.py) chains K serially dependent uint32 operations
a = body(a, x) over one [256, 512] tile, one chain per element, for the
five bodies phe_tpu measures: mul, add, muladd, shiftmul and a
Barrett-shaped reduction step. Two K values (4,000 and 32,000) cancel the
fixed launch cost: the time per iteration is the difference of the two
times over the difference of the K, each time taken with CUDA events
around n back-to-back launches. profiling.py's H100 row records the
result.

A fold guard refuses a result whose K = 32,000 time is not at least 4x
the K = 4,000 time: a compiler that folded the chain would leave a time
that does not grow with K, and a rate that measures nothing. The bench
needs a card and raises without one: a CPU run never prints a rate.

Run on the card:  python -m phe_tpu_torch.microbench
"""

import numpy as np
import torch

from phe_tpu_torch.ops import cuda_microbench as cm

R, TB = 256, 512
K_LO, K_HI = 4000, 32000
SEED = 20261016
# (name, body, operations per iteration), scripts/vpu_microbench.py:71-75.
ROWS = [(name, name, ops) for name, (_, ops) in cm.BODIES.items()]


def _events_s(fn, n):
    """Seconds per call of fn: CUDA events around n back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n / 1e3


def bench(name, body, ops_per_iter, x, n=8):
    """Sustained lane-iterations per second of one body on the card.

    x: int32 [R, C] on a CUDA device. Prints one row and returns the
    lane rate (elements x iterations per second); the operation rate is
    that times ops_per_iter.
    """
    if not x.is_cuda:
        raise RuntimeError("the issue-rate bench needs a tensor on a CUDA "
                           "card, got one on %s" % x.device)
    for K in (K_LO, K_HI):  # build, load and warm up
        cm.issue_chain(x, body, K)
    torch.cuda.synchronize()
    t_lo = _events_s(lambda: cm.issue_chain(x, body, K_LO), n)
    t_hi = _events_s(lambda: cm.issue_chain(x, body, K_HI), n)
    if t_hi < 4 * t_lo:
        raise RuntimeError(
            "%s: K = %d took %.6f s against %.6f s at K = %d, under 4x: the "
            "chain did not scale with K (folded by the compiler?)"
            % (name, K_HI, t_hi, t_lo, K_LO))
    per_iter = (t_hi - t_lo) / (K_HI - K_LO)
    lane_rate = x.numel() / per_iter
    print("%-10s %7.4f ns/iter  %8.1f G lane-iter/s  %6.2f T op/s (%d op/iter)"
          "  [K=%d %.4f ms, K=%d %.4f ms]"
          % (name, per_iter * 1e9, lane_rate / 1e9,
             lane_rate * ops_per_iter / 1e12, ops_per_iter, K_LO, 1e3 * t_lo,
             K_HI, 1e3 * t_hi))
    return lane_rate


def main():
    """Measure the five bodies; return the two calibration rates."""
    from phe_tpu_torch import profiling

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: the "
                           "calibration needs an NVIDIA GPU")
    dev = torch.device("cuda")
    print("device:", torch.cuda.get_device_name(dev))
    print("card:", profiling.card_line())
    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(rng.integers(1, 1 << 14, (R, TB), dtype=np.int32),
                        device=dev)
    rates = {name: bench(name, body, ops, x) for name, body, ops in ROWS}
    out = {"int32_mul_per_s": rates["mul"],
           "int32_mixed_op_per_s": rates["barrett"] * cm.BODIES["barrett"][1]}
    print("\ncalibration: int32_mul_per_s = %.4g, int32_mixed_op_per_s = %.4g"
          % (out["int32_mul_per_s"], out["int32_mixed_op_per_s"]))
    return out


if __name__ == "__main__":
    main()
