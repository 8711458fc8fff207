"""The int32 issue-rate chain: the CUDA kernel and its plain version.

The counterpart of scripts/vpu_microbench.py's ``_mk``: K serially
dependent uint32 operations a = body(a, x) per element, starting from
a = x, with one of five bodies (``BODIES``), all mod 2^32.
``issue_chain`` launches the kernel of ``csrc/microbench.cu`` for a tensor
on the card and takes ``issue_chain_plain`` for a tensor on the CPU; any
other device raises. Inputs and outputs are int32 tensors holding uint32
bit patterns.

``launches`` counts the kernel's launches; nothing else changes it.
"""

import ctypes

import torch

from phe_tpu_torch.ops import _build

# Body name -> (kernel's body index, operations per iteration), as
# scripts/vpu_microbench.py:71-75 counts them.
BODIES = {
    "mul": (0, 1),
    "add": (1, 1),
    "muladd": (2, 2),
    "shiftmul": (3, 3),
    "barrett": (4, 7),
}
launches = {"vpu_microbench": 0}

_MASK = 0xFFFFFFFF


def _lib():
    fn = _build.load("microbench").phe_issue_chain
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return fn


def _mul32(a, b):
    """a * b mod 2^32 for int64 a, b in [0, 2^32), with no int64 overflow:
    a's low half times b is below 2^48, and of its high half times b only
    the low 16 bits survive the shift."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def _step_plain(body, a, x):
    if body == "mul":
        return _mul32(a, x)
    if body == "add":
        return (a + x) & _MASK
    if body == "muladd":
        return (_mul32(a, x) + x) & _MASK
    if body == "shiftmul":
        return _mul32(a >> 14, x) >> 14
    q = _mul32(a >> 14, x) >> 14  # barrett
    r = (a - _mul32(q, x)) & _MASK
    return torch.where(r >= x, r - x, r)


def issue_chain_plain(x, body, K):
    """Plain PyTorch version of the kernel: the chain in int64, masked to 32
    bits after every multiply, add and subtract (CPU torch has no uint32
    arithmetic). Returns the same int32 bit pattern as the kernel."""
    if body not in BODIES:
        raise ValueError("unknown body %r; one of %s" % (body, sorted(BODIES)))
    xv = x.to(torch.int64) & _MASK
    a = xv
    for _ in range(K):
        a = _step_plain(body, a, xv)
    return (a - ((a >> 31) << 32)).to(torch.int32)


def _launch(x, body, K):
    if body not in BODIES:
        raise ValueError("unknown body %r; one of %s" % (body, sorted(BODIES)))
    if x.dtype != torch.int32:
        raise TypeError("x must be int32, got %s" % x.dtype)
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [R, C] tensor, got shape %s"
                         % (tuple(x.shape),))
    if not 0 <= K < 1 << 31 or x.numel() >= 1 << 31:
        raise ValueError("K and the element count must fit an int32")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rc = _lib()(x.data_ptr(), out.data_ptr(), x.numel(), K, BODIES[body][0],
                _build.stream_handle(x.device))
    if rc != 0:
        raise RuntimeError("vpu_microbench kernel launch failed: CUDA error %d"
                           % rc)
    launches["vpu_microbench"] += 1
    return out


def issue_chain(x, body, K):
    """K chained body(a, x) steps per element of an int32 [R, C] tensor."""
    if x.device.type == "cuda":
        return _launch(x, body, K)
    if x.device.type == "cpu":
        return issue_chain_plain(x, body, K)
    raise ValueError("no issue chain for device %s" % x.device)
