"""Batched Montgomery products and modexps: the CUDA kernels and their
plain versions.

The counterpart of phe_tpu/ops/pallas_modexp.py. ``mont_mul`` and
``mont_mul_const`` (``mont_mul_cols``, ``mont_mul_const_cols``) launch the
kernel of ``csrc/mont_mul.cu``; ``mont_pow_shared`` and ``mont_pow``
(``mont_pow_shared_cols``, ``mont_pow_cols``: the windowed modexp with an
exponent shared by the batch or one per row) launch the kernel of
``csrc/mont_pow.cu``. Each launches its kernel for tensors on the card and
takes its plain PyTorch version (montgomery.mont_mul_plain,
mont_pow_shared_plain, mont_pow_plain) for tensors on the CPU; any other
device raises.

The contract (phe_tpu's tests state it for its kernels): for inputs below
2.01 M with limbs in [0, 2^14], the output is congruent to a*b*R^-1 mod M
(x^e R mod M for the modexps, with x in Montgomery form), has limbs in
[0, 2^14] and value < 1.01 M. Kernel and plain version agree in value mod
M, not necessarily limb for limb.

``launches`` counts the kernel launches of each form; nothing else changes
it.
"""

import ctypes

import torch

from phe_tpu_torch.ops import _build
from phe_tpu_torch.ops import cuda_rns
from phe_tpu_torch.ops import montgomery as mg

# The dynamic shared memory a block can have on Hopper (227 KB). mont_mul
# takes 48 L bytes (L <= 4842), mont_pow 4L (2^w + 4) + 32 L.
MAX_SMEM = 232448
launches = {"mont_mul": 0, "mont_mul_const": 0, "mont_pow_shared": 0,
            "mont_pow": 0}

mont_mul_plain = mg.mont_mul_plain


def _lib():
    lib = _build.load("mont_mul")
    fn = lib.phe_mont_mul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return fn


def _pow_lib(vec):
    lib = _build.load("mont_pow")
    if lib.phe_mont_pow.argtypes is None:
        for fn in (lib.phe_mont_pow, lib.phe_mont_pow_shared):
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p
            ]
            fn.restype = ctypes.c_int
    return lib.phe_mont_pow if vec else lib.phe_mont_pow_shared


def _check(t, name, shape, device):
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != torch.int64:
        raise TypeError("%s must be int64, got %s" % (name, t.dtype))
    if tuple(t.shape) != shape:
        raise ValueError(
            "%s has shape %s, expected %s" % (name, tuple(t.shape), shape)
        )
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def _launch(a, b, ctx, shared):
    if a.dim() != 2:
        raise ValueError("a must be [B, L], got shape %s" % (tuple(a.shape),))
    B, L = a.shape
    if L != ctx.num_limbs or L % 8 or 48 * L > MAX_SMEM:
        raise ValueError(
            "limb count %d: need the context's L = %d, a multiple of 8, "
            "with 48 L <= %d bytes" % (L, ctx.num_limbs, MAX_SMEM)
        )
    dev = a.device
    _check(a, "a", (B, L), dev)
    _check(b, "b", (L,) if shared else (B, L), dev)
    _check(ctx.m, "ctx.m", (L,), dev)
    _check(ctx.m_prime, "ctx.m_prime", (L,), dev)
    out = torch.empty_like(a)
    if B == 0:
        return out
    rc = _lib()(
        a.data_ptr(), b.data_ptr(), ctx.m.data_ptr(), ctx.m_prime.data_ptr(),
        out.data_ptr(), B, L, int(shared), _build.stream_handle(dev),
    )
    if rc != 0:
        raise RuntimeError("mont_mul kernel launch failed: CUDA error %d" % rc)
    launches["mont_mul_const" if shared else "mont_mul"] += 1
    return out


def _dispatch(a, b, ctx, shared):
    if a.device.type == "cuda":
        return _launch(a, b, ctx, shared)
    if a.device.type == "cpu":
        return mont_mul_plain(a, b, ctx)
    raise ValueError("no Montgomery product for device %s" % a.device)


def mont_mul(a, b, ctx):
    """a*b*R^-1 mod M for a, b [B, L] int64 (value < 1.01 M)."""
    return _dispatch(a, b, ctx, shared=False)


def mont_mul_const(a, b_limbs, ctx):
    """a*b*R^-1 mod M for a [B, L] against one shared b [L]."""
    return _dispatch(a, b_limbs, ctx, shared=True)


def _pow_launch(base, digits, ctx, window, vec):
    if base.dim() != 2:
        raise ValueError("base must be [B, L], got shape %s"
                         % (tuple(base.shape),))
    B, L = base.shape
    smem = 4 * L * ((1 << window) + 4) + 32 * L if 1 <= window <= 8 else 0
    if L != ctx.num_limbs or not 0 < smem <= MAX_SMEM:
        raise ValueError(
            "limb count %d at window %d: need the context's L = %d and "
            "window in [1, 8] with 4L(2^w + 4) + 32L <= %d bytes"
            % (L, window, ctx.num_limbs, MAX_SMEM)
        )
    dev = base.device
    _check(base, "base", (B, L), dev)
    for name in ("m", "m_prime", "one"):
        _check(getattr(ctx, name), "ctx." + name, (L,), dev)
    if vec:
        digits = cuda_rns._digit_rows_on(digits, window, B, dev)
    else:
        digits = cuda_rns._digits_on(digits, window, dev)
    out = torch.empty_like(base)
    if B == 0:
        return out
    rc = _pow_lib(vec)(
        base.data_ptr(), out.data_ptr(), ctx.m.data_ptr(),
        ctx.m_prime.data_ptr(), ctx.one.data_ptr(), digits.data_ptr(), B, L,
        digits.shape[-1], window, _build.stream_handle(dev),
    )
    name = "mont_pow" if vec else "mont_pow_shared"
    if rc != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (name, rc))
    launches[name] += 1
    return out


def mont_pow_shared(base, digits, ctx, window=mg.DEFAULT_WINDOW):
    """base^e R mod M for base [B, L] in Montgomery form; digits
    [n_windows], the MSB-first schedule of e shared by the batch."""
    if base.device.type == "cuda":
        return _pow_launch(base, digits, ctx, window, vec=False)
    if base.device.type == "cpu":
        return mg.mont_pow_shared_plain(base, digits, ctx, window=window)
    raise ValueError("no Montgomery modexp for device %s" % base.device)


def mont_pow(base, digits, ctx, window=mg.DEFAULT_WINDOW):
    """base_i^e_i R mod M for base [B, L] in Montgomery form; digits
    [B, n_windows], one schedule per row (int8 on the card, any integer
    type on the host)."""
    if base.device.type == "cuda":
        return _pow_launch(base, digits, ctx, window, vec=True)
    if base.device.type == "cpu":
        return mg.mont_pow_plain(base, digits, ctx, window=window)
    raise ValueError("no Montgomery modexp for device %s" % base.device)
