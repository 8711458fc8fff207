"""Batched fixed-width big-integer arithmetic in base-2^14 limbs.

The PyTorch counterpart of phe_tpu/ops/limb_math.py. Whole batches of big
integers live as ``int64[..., L]`` tensors (least-significant limb first)
and flow through vectorised multiply / carry / reduce steps. Every function
is shape-polymorphic over leading (batch) dims and runs on any device.

Limbs travel as int64 because CPU PyTorch has no uint32 add, shift or
compare; every bound below stays under 2**31, so int64 never wraps and
each step computes the same integers as the uint32 reference.

Representation and bounds
=========================
A big integer is ``sum(limb[i] << (14 * i))`` with limbs held *redundantly*:
the invariant restored after every step is ``limb <= 2**14`` (one over the
canonical maximum 2**14 - 1). That makes a **fixed three-pass carry** sound:

* products: operand limbs <= 2**14 give partial products <= 2**28;
* schoolbook accumulation: an output slot receives at most 2L product
  halves, each <= 2**14, so slots stay < 2L * 2**14 < 2**31 for L < 2**16;
* carry pass 1 on slots < 2**31 leaves limbs < 2**14 + 2**17;
* pass 2 carries are <= 9, leaving limbs <= 2**14 + 8;
* pass 3 carries are <= 1, restoring limbs <= 2**14.

Carries out of the top limb are dropped by design: all callers bound the
represented value below the array's capacity, and with non-negative limbs
that forces the dropped carry to be zero.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

LIMB_BITS = 14
LIMB_MASK = (1 << LIMB_BITS) - 1


def matmul_exact(x, w):
    """Exact integer product x @ w of small-integer tensors -> int64.

    CUDA's torch.matmul has no integer path, so both operands go through
    float64, on the CPU and on the card alike. Every call site keeps each
    output's partial sums below 2**25 in magnitude (the digit-sum bounds
    documented at the call sites), far inside float64's 2**53 exact-integer
    range, so any summation order gives the exact integer. float32 would sit
    at the edge of exactness and TF32 would break it.
    """
    return torch.matmul(x.to(torch.float64), w.to(torch.float64)).to(
        torch.int64
    )


def _shift_up(c):
    """Move a carry vector up one limb (c[i] contributes at position i+1)."""
    return F.pad(c[..., :-1], (1, 0))


def carry_pass(x):
    """One redistribute step: keep low 14 bits, push the rest up one limb."""
    return (x & LIMB_MASK) + _shift_up(x >> LIMB_BITS)


def carry_fix(x):
    """Restore the redundant invariant (limbs <= 2**14) for slots < 2**31."""
    return carry_pass(carry_pass(carry_pass(x)))


def add(a, b):
    """Redundant add of equal-width limb arrays (limb sums <= 2**16)."""
    return carry_fix(a + b)


def diag_sum(m):
    """Anti-diagonal sums: [..., R, C] -> [..., R+C-1], out[k] = sum_i m[i, k-i].

    Static shear: pad each row with R zeros, flatten the last two axes,
    drop the final R elements and reshape to [R, C+R-1] — row i lands
    shifted right by i, so a sum over rows realigns m[i, j] onto slot i+j.
    """
    batch = m.shape[:-2]
    R, C = m.shape[-2], m.shape[-1]
    if R == 1:
        return m[..., 0, :]
    p = F.pad(m, (0, R))
    f = p.reshape(batch + (R * (C + R),))[..., : R * (C + R - 1)]
    return f.reshape(batch + (R, C + R - 1)).sum(dim=-2)


def mul_full(a, b):
    """Full schoolbook product: [..., La] x [..., Lb] -> [..., La+Lb].

    One broadcast outer product gives every partial product (< 2**28); the
    14-bit halves are summed along anti-diagonals (diag_sum). Output slots
    receive at most 2*min(La, Lb) halves of <= 2**14 each, staying under
    2**31 for the one carry_fix at the end. Requires
    value(a) * value(b) < 2**(14 * (La + Lb)).
    """
    outer = a[..., :, None] * b[..., None, :]  # [..., La, Lb]
    lo = diag_sum(outer & LIMB_MASK)  # contributes at slot i+j
    hi = diag_sum(outer >> LIMB_BITS)  # contributes at slot i+j+1
    return carry_fix(F.pad(lo, (0, 1)) + F.pad(hi, (1, 0)))


def mul_low(a, b, out_limbs):
    """Low ``out_limbs`` limbs of a*b: the product mod 2**(14*out_limbs)."""
    return mul_full(a[..., :out_limbs], b[..., :out_limbs])[..., :out_limbs]


def shift_right_limbs_exact(x, nlimbs):
    """Divide by R = 2**(14*nlimbs) when value(x) is an exact multiple of R.

    In redundant form the low limbs' partial sum is a multiple of R and
    < 2R (limbs <= 2**14), hence 0 or exactly R: the carry into the high
    half is 1 iff any low limb is non-zero.
    """
    carry = (x[..., :nlimbs] != 0).any(dim=-1).to(x.dtype)
    high = x[..., nlimbs:].clone()
    high[..., 0] += carry
    return carry_fix(high)


def normalize(x):
    """Fully propagate carries to canonical limbs (<= 2**14 - 1).

    For limbs in [0, 2**31), the bound every caller keeps: carry_fix
    brings them to <= 2**14, and one carry-lookahead finishes. With
    g_i = (x_i == 2**14) and p_i = (x_i == 2**14 - 1), the carry into
    limb i + 1 is g_j for the last j <= i with not p_j (none: no carry),
    found by a running maximum over the indices. The carry out of the top
    limb is dropped, as carry_pass drops it: the result is the canonical
    form of value mod 2**(14 L), the fixed point phe_tpu's while_loop
    reaches. A fixed count of tensor ops for any input, and no read on
    the host: a +1 rippling through a run of 2**14 - 1 limbs costs the
    same as any other input.
    """
    x = carry_fix(x)
    idx = _positions(x.shape[-1], x.device)
    last, _ = torch.cummax(torch.where(x != LIMB_MASK, idx, -1), dim=-1)
    carry = torch.gather(x >> LIMB_BITS, -1, last.clamp(min=0)) * (last >= 0)
    return (x + _shift_up(carry)) & LIMB_MASK


@functools.lru_cache(maxsize=None)
def _positions(L, device):
    """int64 [L] limb indices on device, made once per (L, device)."""
    return torch.arange(L, device=device)


@functools.lru_cache(maxsize=None)
def _pack_index(L, device):
    """pack_bytes's gathers for L limbs on device: (lo limb, hi limb,
    shift, hi present), made once per (L, device) so that no call copies
    from the host."""
    nbytes = (LIMB_BITS * L + 7) // 8
    j = np.arange(nbytes)
    a = (8 * j) // LIMB_BITS
    return tuple(torch.as_tensor(v.astype(np.int64), device=device) for v in (
        a, np.minimum(a + 1, L - 1), (8 * j) % LIMB_BITS, a + 1 < L))


@functools.lru_cache(maxsize=None)
def _unpack_index(num_limbs, device):
    """unpack_bytes's (first byte, shift) of each limb on device, made
    once per (num_limbs, device)."""
    j = np.arange(num_limbs)
    return (torch.as_tensor((LIMB_BITS * j) // 8, device=device),
            torch.as_tensor((LIMB_BITS * j) % 8, device=device))


def pack_bytes(x):
    """Canonical limbs [..., L] -> little-endian bytes [..., ceil(14L/8)].

    Byte j covers bits [8j, 8j+8), spanning at most two 14-bit limbs: two
    index gathers and a shift-or. Input must be canonical.
    """
    a, a1, s, hi_ok = _pack_index(x.shape[-1], x.device)
    lo = x[..., a] >> s
    hi = x[..., a1] * hi_ok
    return ((lo | (hi << (LIMB_BITS - s))) & 0xFF).to(torch.uint8)


def unpack_bytes(buf, num_limbs):
    """Little-endian bytes [..., nbytes] -> limbs [..., num_limbs].

    Limb j covers bits [14j, 14j+14), spanning at most three bytes: three
    index gathers, a shift and a mask. Bits beyond the limbs are ignored.
    """
    need = (LIMB_BITS * num_limbs + 7) // 8 + 2
    b = buf.to(torch.int64)
    if b.shape[-1] < need:
        b = F.pad(b, (0, need - b.shape[-1]))
    o, s = _unpack_index(num_limbs, b.device)
    word = b[..., o] | (b[..., o + 1] << 8) | (b[..., o + 2] << 16)
    return (word >> s) & LIMB_MASK


def cond_sub(x, m_complement, m_width):
    """Map canonical x < 2M into [0, M): subtract M once if x >= M.

    Branch-free via the radix complement comp = R - M: s = x + comp < 2R,
    and after normalisation over m_width+1 limbs the top limb is 1 iff
    x >= M, in which case the low limbs are exactly x - M.
    """
    s = F.pad(x, (0, 1)) + F.pad(m_complement.expand(x.shape), (0, 1))
    s = normalize(s)
    ge = s[..., m_width] >= 1
    return torch.where(ge[..., None], s[..., :m_width], x)
