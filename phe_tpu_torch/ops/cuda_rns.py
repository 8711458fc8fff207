"""The RNS ladders: the CUDA kernel and the dispatch to its plain versions.

The counterpart of phe_tpu/ops/pallas_rns.py's ``ladder_cols`` (exponent
shared by the batch) and ``ladder_vec_cols`` (one exponent per element).
``ladder`` and ``ladder_vec`` launch the kernel of ``csrc/rns_ladder.cu``
for residues on the card and run the plain PyTorch versions,
``rns.ladder_plain`` and ``rns.ladder_vec_plain``, for residues on the CPU;
any other device raises. Every residue is canonical, so kernel and plain
version are bit-equal: the same integers at every step.

``launches`` counts the kernel launches of each form; nothing else changes
it.
"""

import ctypes

import torch
from torch.utils.weak import WeakIdKeyDictionary

from phe_tpu_torch.ops import _build
from phe_tpu_torch.ops import rns

launches = {"rns_ladder": 0, "rns_ladder_vec": 0}

# The system's [cpad] int64 rows the kernel reads, in its argument order.
_ROWS = ("m", "mu", "t14", "sig1", "sig2", "d1", "d2", "e1", "neg_mb",
         "one_dom")
# Per system, keyed by its w_ext1 tensor: both extension matrices packed
# for the kernel, built at the system's first launch.
_packed = WeakIdKeyDictionary()


def _lib(vec):
    lib = _build.load("rns_ladder")
    if lib.phe_rns_ladder_elems.argtypes is None:
        for fn in (lib.phe_rns_ladder, lib.phe_rns_ladder_vec):
            fn.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                + [ctypes.c_void_p] * (len(_ROWS) + 6)
                + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
        lib.phe_rns_ladder_elems.restype = ctypes.c_int
        lib.phe_rns_ladder_elems.argtypes = []
    fn = lib.phe_rns_ladder_vec if vec else lib.phe_rns_ladder
    return fn, lib.phe_rns_ladder_elems()


def _pack(w):
    """int8 [3K, 2k] -> int32 [2k/4, 3K]: row r's 4-digit words, column-wise."""
    return w.contiguous().view(torch.int32).t().contiguous()


def _columns(sys_):
    """(w_ext1, w_ext2) packed for the kernel, once per system."""
    cols = _packed.get(sys_.w_ext1)
    if cols is None:
        cols = _packed[sys_.w_ext1] = (_pack(sys_.w_ext1), _pack(sys_.w_ext2))
    return cols


def _digits_on(digits, window, dev):
    """The digit schedule as contiguous int64 [n_windows] on dev.

    A schedule from the host is range-checked before its upload. One
    already on the card was built by mg.exponent_digits at this window, so
    its digits lie in [0, 2^window): checking them would sync with the
    host at every launch. The kernel masks each digit to the window.
    """
    if not (isinstance(digits, torch.Tensor) and digits.device == dev):
        host = torch.as_tensor(digits, dtype=torch.int64, device="cpu")
        if not bool(((host >= 0) & (host < (1 << window))).all()):
            raise ValueError("digits must lie in [0, 2^window)")
        digits = host.to(dev)
    if digits.dtype != torch.int64 or digits.dim() != 1:
        raise ValueError("digits must be 1-D int64, got %s %s"
                         % (digits.dtype, tuple(digits.shape)))
    return digits.contiguous()


def _digit_rows_on(digits, window, rows, dev):
    """Per-element schedules as contiguous int8 [rows, n_windows] on dev.

    Schedules from the host are range-checked before their upload; one
    already on the card (the wire form of batch._digits_rows) is taken as
    it is, and the kernel masks each digit to the window.
    """
    if not (isinstance(digits, torch.Tensor) and digits.device == dev):
        host = torch.as_tensor(digits, device="cpu")
        if not bool(((host >= 0) & (host < (1 << window))).all()):
            raise ValueError("digits must lie in [0, 2^window)")
        digits = host.to(torch.int8).to(dev)
    if digits.dtype != torch.int8 or digits.dim() != 2 or (
            digits.shape[0] != rows):
        raise ValueError("digits must be int8 [%d, n_windows], got %s %s"
                         % (rows, digits.dtype, tuple(digits.shape)))
    return digits.contiguous()


def _row(t, name, C, dev):
    if t.device != dev or t.dtype != torch.int64 or tuple(t.shape) != (C,):
        raise ValueError("%s must be int64 [%d] on %s, got %s %s on %s"
                         % (name, C, dev, t.dtype, tuple(t.shape), t.device))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
    return t.data_ptr()


def _launch(x_res, digits, sys_, window, exit_res, entry_res, vec):
    dev = x_res.device
    C, k = sys_.cpad, sys_.k
    if x_res.dim() != 2 or x_res.shape[1] != C:
        raise ValueError(
            "x_res must be [B, %d], got shape %s" % (C, tuple(x_res.shape))
        )
    if x_res.dtype != torch.int64 or not x_res.is_contiguous():
        raise TypeError("x_res must be contiguous int64")
    if not 1 <= window <= 8:
        raise ValueError("window must be in [1, 8], got %d" % window)
    if vec:
        digits = _digit_rows_on(digits, window, x_res.shape[0], dev)
    else:
        digits = _digits_on(digits, window, dev)
    entry = sys_.r2_dom if entry_res is None else entry_res
    exitc = sys_.scale if exit_res is None else exit_res
    rows = [_row(getattr(sys_, f), "sys_." + f, C, dev) for f in _ROWS]
    rows += [_row(entry, "entry_res", C, dev), _row(exitc, "exit_res", C, dev),
             _row(sys_.mbinv_r, "sys_.mbinv_r", 1, dev)]
    for name in ("w_ext1", "w_ext2"):
        if getattr(sys_, name).device != dev:
            raise ValueError("sys_.%s is not on %s" % (name, dev))
    B = x_res.shape[0]
    out = torch.empty_like(x_res)
    if B == 0:
        return out
    w1p, w2p = _columns(sys_)
    fn, elems = _lib(vec)
    table = torch.empty(
        (-(-B // elems) * elems, 1 << window, C), dtype=torch.int32, device=dev
    )
    rc = fn(
        x_res.data_ptr(), out.data_ptr(), table.data_ptr(), B, k, C,
        *rows, w1p.data_ptr(), w2p.data_ptr(),
        digits.data_ptr(), digits.shape[-1], window, _build.stream_handle(dev),
    )
    name = "rns_ladder_vec" if vec else "rns_ladder"
    if rc != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (name, rc))
    launches[name] += 1
    return out


def ladder(x_res, digits, sys_, window=rns.DEFAULT_WINDOW, exit_res=None,
           entry_res=None):
    """Windowed RNS modexp over [B, cpad] stored residues, shared exponent.

    Returns [B, cpad] residues of (x F)^e E mod N, value <= kN + 1 (see
    rns.ladder_plain for the entry constant F and exit constant E).
    """
    if x_res.device.type == "cuda":
        return _launch(x_res, digits, sys_, window, exit_res, entry_res,
                       vec=False)
    if x_res.device.type == "cpu":
        return rns.ladder_plain(x_res, digits, sys_, window=window,
                                exit_res=exit_res, entry_res=entry_res)
    raise ValueError("no RNS ladder for device %s" % x_res.device)


def ladder_vec(x_res, digits, sys_, window=rns.DEFAULT_WINDOW, exit_res=None,
               entry_res=None):
    """Windowed RNS modexp over [B, cpad] stored residues, per-element
    exponents: digits [B, n_windows], int8 on the card or any integer type
    on the host. Returns [B, cpad] residues of (x F)^e_i E mod N, value
    <= kN + 1 (see rns.ladder_vec_plain).
    """
    if x_res.device.type == "cuda":
        return _launch(x_res, digits, sys_, window, exit_res, entry_res,
                       vec=True)
    if x_res.device.type == "cpu":
        return rns.ladder_vec_plain(x_res, digits, sys_, window=window,
                                    exit_res=exit_res, entry_res=entry_res)
    raise ValueError("no RNS ladder for device %s" % x_res.device)
