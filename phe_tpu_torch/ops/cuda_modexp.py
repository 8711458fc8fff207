"""Batched Montgomery products: the CUDA kernel and its plain version.

The counterpart of phe_tpu/ops/pallas_modexp.py's ``mont_mul_cols`` and
``mont_mul_const_cols``. ``mont_mul`` and ``mont_mul_const`` launch the
kernel of ``csrc/mont_mul.cu`` for tensors on the card and take the plain
PyTorch version, ``redc(mul_full(a, b))``, for tensors on the CPU; any
other device raises.

The contract (phe_tpu's tests state it for its kernel): for inputs below
2.01 M with limbs in [0, 2^14], the output is congruent to a*b*R^-1 mod M,
has limbs in [0, 2^14] and value < 1.01 M. Kernel and plain version agree
in value mod M, not necessarily limb for limb.

``launches`` counts the kernel launches of each form; nothing else changes
it.
"""

import ctypes

import torch

from phe_tpu_torch.ops import _build
from phe_tpu_torch.ops import limb_math as lm
from phe_tpu_torch.ops import montgomery as mg

MAX_LIMBS = 1016  # shared memory: 48 L bytes per block, under 48 KB
launches = {"mont_mul": 0, "mont_mul_const": 0}


def mont_mul_plain(a, b, ctx):
    """Plain PyTorch version: a, b [B, L] (or b [L]) -> [B, L]."""
    return mg.redc(lm.mul_full(a, b.expand(a.shape)), ctx)


def _lib():
    lib = _build.load("mont_mul")
    fn = lib.phe_mont_mul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return fn


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
    if L != ctx.num_limbs or L % 8 or L > MAX_LIMBS:
        raise ValueError(
            "limb count %d: need the context's L = %d, a multiple of 8, "
            "at most %d" % (L, ctx.num_limbs, MAX_LIMBS)
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
