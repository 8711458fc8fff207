"""Profiling and roofline accounting for the port on an NVIDIA GPU.

The port of phe_tpu/profiling.py: (a) a torch.profiler trace context for
capturing the card's timeline, and the program's spans on it; (b) an
analytic roofline, per-unit work counts against per-unit peaks, so
benchmark numbers are judged against speed of light rather than only
against the CPython baseline.

The spans: ``span(name)`` marks a stretch of the program's own work as a
``torch.profiler.record_function`` range while a profiler session records
(``trace()``, or any ``torch.profiler.profile``), so it lies on the
profiler's clock beside the card's kernels and copies; with no session it
is a shared null context and records nothing. Every name the program
emits is in ``SPANS``:

* host encode and decode work, ``HOST_SPANS``: ``batch.encode`` (the
  values' encodings), ``batch.pack`` (packing residues into rows and their
  upload), ``batch.draw_r`` (the CSPRNG draw of r and its upload),
  ``batch.schedule`` (per-element digit schedules and their upload),
  ``batch.decode`` (the decode of decrypted rows);
* ``batch.readback``: a device-to-host copy that waits on the card, inside
  ``batch.decode`` on the decrypt path;
* ``program.<fn>``: one call of a device program (programs.py), its
  key, copies and graph replay, warm-up or capture, or its eager body.

A host span holds no program call, so its self time is host work, and the
innermost span open over an idle stretch of the card names what the host
was doing.

The unit keys keep phe_tpu's names, so the JSON rows have its schema. On
Hopper they mean:

* ``vpu_u32_mul``: int32 multiplies on the SMs' integer pipes;
* ``vpu_op``: int32 operations of any kind (multiply, add, shift,
  compare, select) issued on the SMs;
* ``mxu_i8_mac``: int8 multiply-adds on the tensor cores.

The cost models are phe_tpu's, number for number: they count the work of
the algorithms as phe_tpu's kernels do it (REDC and the RNS base
extensions as int8 digit matmuls), whatever the port's kernels do today.

Cost model of one Montgomery multiply over L limbs:

* **tensor-core path** (mxu=True): the data-dependent a*b schoolbook, L^2
  int32 multiplies plus a similar count of aligns and adds, and both REDC
  products as int8 constant matmuls over 7-bit digits: [2L, 2L] and
  [4L, 2L] against a [2L] digit column = 12 L^2 int8 multiply-adds.
* **integer-pipe path** (mxu=False): all three products schoolbook,
  ~3 L^2 int32 multiplies.

A w-bit windowed modexp of an e-bit exponent costs
ceil(e/w)*(w+1) + 2^w - 2 Montgomery multiplies. The per-op time lower
bound takes the MAX over units (each unit at its own peak, overlap
perfect), so speed_of_light_fraction <= 1 when the peaks are right.
"""

import contextlib
import os
import subprocess

import torch

from phe_tpu_torch import config

# Per-card peaks: (int32 mul/s, int32 op/s, int8 tensor-core MAC/s).
# The two int32 rates were measured by python -m phe_tpu_torch.microbench
# on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (SM clock 1,980
# MHz): the mul body's lane rate (one IMAD an iteration), and the barrett
# body's lane rate times its 7 counted operations (8 instructions an
# iteration, spread over the integer and multiply-add pipes, so it
# exceeds the 16.7 T/s of 64 int32 lanes an SM). The int8 peak is
# NVIDIA's data sheet: 1,979 TOP/s dense, two operations a MAC.
_H100_INT32_MUL = 15.8677e12
_H100_INT32_OP = 20.2965e12
_H100_INT8_MAC = 1979e12 / 2
_CHIP_PEAKS = {"h100": (_H100_INT32_MUL, _H100_INT32_OP, _H100_INT8_MAC)}
_DEFAULT_PEAKS = _CHIP_PEAKS["h100"]

HOST_SPANS = frozenset(("batch.encode", "batch.pack", "batch.draw_r",
                        "batch.schedule", "batch.decode"))
# Every name span() is given; device_program adds its program.<fn> names.
SPANS = set(HOST_SPANS | {"batch.readback"})
_OFF = contextlib.nullcontext()


def span(name):
    """A record_function range named name while a torch.profiler session
    records, else a shared null context (one check, nothing allocated)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def chip_peaks(device_kind=None):
    """((int32 mul/s, int32 op/s, int8 MAC/s), kind, assumed).

    device_kind defaults to torch.cuda.get_device_name(0), or "cpu" with
    no card. A kind naming an H100 gets the measured row with
    assumed=False; any other kind, the CPU included, gets the H100 row
    with assumed=True, so reports can flag it.
    """
    if device_kind is None:
        device_kind = (torch.cuda.get_device_name(0)
                       if torch.cuda.is_available() else "cpu")
    kind = device_kind.lower()
    for key, peaks in _CHIP_PEAKS.items():
        if key in kind:
            return peaks, device_kind, False
    return _DEFAULT_PEAKS, device_kind, True


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ""


def mont_mul_cost(limbs, mxu=True):
    """Unit costs for one limb-engine Montgomery multiply.

    vpu_op (total int32 issue) is estimated at 2x the multiply count for
    the schoolbook (align/add per product).
    """
    L2 = limbs * limbs
    if mxu:
        return {"vpu_u32_mul": L2, "vpu_op": 2 * L2, "mxu_i8_mac": 12 * L2}
    return {"vpu_u32_mul": 3 * L2, "vpu_op": 6 * L2, "mxu_i8_mac": 0}


def _scale(cost, k):
    return {unit: k * ops for unit, ops in cost.items()}


def _add(a, b):
    return {unit: a[unit] + b[unit] for unit in a}


def modexp_cost(exponent_bits, limbs, window=4, mxu=True):
    """Unit costs of one windowed Montgomery modexp."""
    n_windows = -(-exponent_bits // window)
    montmuls = n_windows * (window + 1) + 2**window - 2
    return _scale(mont_mul_cost(limbs, mxu), montmuls)


def encrypt_cost(n_bits, limbs_nsq, window=4, mxu=True):
    """One fresh encryption: the r^n obfuscator modexp plus the (n*m+1)
    prologue multiply and the final ciphertext multiply."""
    return _add(
        modexp_cost(n_bits, limbs_nsq, window, mxu),
        _scale(mont_mul_cost(limbs_nsq, mxu), 2),
    )


def decrypt_cost(n_bits, limbs_halfsq, window=4, mxu=True):
    """One CRT decryption: two half-width (n/2-bit exponent) modexps."""
    return _scale(modexp_cost(n_bits // 2, limbs_halfsq, window, mxu), 2)


# -- RNS (Cox-Rower) engine cost model (phe_tpu_torch/ops/rns.py) -----------
#
# One fused tau-domain RNS Montgomery product over k channels per base
# (cpad ~ 2k + 8), counting int32 multiplies (rns.rns_mont_mul):
#   raw product 2k; sigma 4k (2 products + steps-3 Barrett); qhat
#   combine+reduce 5(k+8); fused u~ 5(k+8); S combine 3(k+8); u_a 3k
#   => ~22k + O(1) multiplies,
# plus the two base-extension int8 matmuls: 2 * [3(k+8), 2k] digit rows
# = 12 k (k+8) MACs. Total int32 issue (shifts, masks, adds, compares,
# selects alongside the multiplies, from a static count of phe_tpu's
# kernel body) is ~3.3x the multiply count; the mixed-stream rate in
# chip_peaks prices that bound.


def rns_mont_mul_cost(k):
    """Unit costs for one fused RNS Montgomery product."""
    mul = 22 * k + 120
    return {
        "vpu_u32_mul": mul,
        "vpu_op": int(3.3 * mul),
        "mxu_i8_mac": 12 * k * (k + 8),
    }


def rns_modexp_cost(exponent_bits, k, window):
    """Unit costs of one windowed RNS modexp (incl. entry/exit products)."""
    n_windows = -(-exponent_bits // window)
    montmuls = n_windows * (window + 1) + 2**window - 2 + 2
    return _scale(rns_mont_mul_cost(k), montmuls)


def rns_vec_modexp_cost(exponent_bits, k, window):
    """Per-element-exponent RNS modexp: the shared ladder plus the
    constant-time select ((2^w - 1) lane selects over all cpad ~ 2k
    channels per window, as phe_tpu prices its select tree)."""
    n_windows = -(-exponent_bits // window)
    sel_ops = n_windows * (2**window - 1) * 2 * k
    return _add(
        rns_modexp_cost(exponent_bits, k, window),
        {"vpu_u32_mul": 0, "vpu_op": sel_ops, "mxu_i8_mac": 0},
    )


def rns_encrypt_cost(n_bits, k, window):
    """Fresh encryption on the RNS engine (obfuscator ladder dominates)."""
    return rns_modexp_cost(n_bits, k, window)


def rns_decrypt_cost(n_bits, k_half, window):
    """CRT decryption: two half-width ladders on half-size channel sets."""
    return _scale(rns_modexp_cost(n_bits // 2, k_half, window), 2)


def ideal_seconds_per_op(cost, peaks=None):
    """Roofline lower bound: each unit at its own peak, perfect overlap.

    Units: int32 multiplies at the measured multiply rate, all int32
    operations at the measured mixed-stream rate, int8 tensor-core MACs at
    the data-sheet peak.
    """
    if peaks is None:
        peaks, _, _ = chip_peaks()
    vpu_mul_peak, vpu_op_peak, mxu_peak = peaks
    return max(
        cost.get("vpu_u32_mul", 0) / vpu_mul_peak,
        cost.get("vpu_op", 0) / vpu_op_peak,
        cost.get("mxu_i8_mac", 0) / mxu_peak,
    )


def report(op, ops_per_s, cost):
    """Roofline report for one measured op.

    speed_of_light_fraction = ideal_time / measured_time <= 1 by
    construction (the bound takes the max over units). The per-unit
    fractions show which unit the kernel is actually limited by.
    """
    peaks, kind, assumed = chip_peaks()
    vpu_mul_peak, vpu_op_peak, mxu_peak = peaks
    ideal = ideal_seconds_per_op(cost, peaks)
    fracs = {
        "vpu_mul_fraction": ops_per_s * cost.get("vpu_u32_mul", 0)
        / vpu_mul_peak,
        "vpu_op_fraction": ops_per_s * cost.get("vpu_op", 0) / vpu_op_peak,
        "mxu_fraction": ops_per_s * cost.get("mxu_i8_mac", 0) / mxu_peak,
    }
    return {
        "op": op,
        "ops_per_s": round(ops_per_s, 2),
        "device_kind": kind,
        "peaks_assumed": assumed,
        "vpu_u32_mul_per_op": int(cost.get("vpu_u32_mul", 0)),
        "vpu_op_per_op": int(cost.get("vpu_op", 0)),
        "mxu_i8_mac_per_op": int(cost.get("mxu_i8_mac", 0)),
        **{name: round(f, 4) for name, f in fracs.items()},
        "speed_of_light_fraction": round(ops_per_s * ideal, 4),
        "bound_by": max(fracs, key=fracs.get).replace("_fraction", ""),
    }


@contextlib.contextmanager
def trace(log_dir=None):
    """Profile a block with torch.profiler (CPU and, with a card, CUDA
    activity); yields the profiler and writes its chrome trace, the
    program's spans among its events, to log_dir/trace.json on exit
    (default: build/trace in the checkout)."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(os.path.dirname(config.build_dir()), "trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
