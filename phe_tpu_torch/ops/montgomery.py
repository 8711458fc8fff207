"""Batched Montgomery modular arithmetic over redundant limb tensors.

The PyTorch counterpart of phe_tpu/ops/montgomery.py, for the operations
the encrypt -> decrypt round trip runs:

* per-modulus constants are computed once on host from Python ints and
  packed into a ``MontgomeryContext`` of int64 tensors on one device;
* the limb count L = ceil((bits(M) + 16) / 14), rounded up to a multiple
  of 8, keeps the Montgomery radix R = 2**(14 L) at least 2**16 above M, so
  the subtraction-free variant holds: every chained value stays < 1.01 M;
* every Montgomery product goes through the hand-written CUDA kernel
  (phe_tpu_torch.ops.cuda_modexp) for tensors on the card, and through its
  plain PyTorch version, ``redc(mul_full(a, b))``, for tensors on the CPU;
  the kernel reduces on the int8 tensor cores against the context's REDC
  matrices or on the CUDA cores' integer pipe, whichever
  ``cuda_modexp._body`` picks at the launch's shape;
* so do the windowed modexps with a shared or a per-element exponent
  (``mont_pow_shared``, ``mont_pow``), whose plain versions are the
  windowed-table loops below;
* the constant-operand products of the decrypt tail (const_mul, the
  mod_reduce fold) are exact int8-digit matmuls (limb_math.matmul_exact).
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from phe_tpu_torch.ops import limb_math as lm
from phe_tpu_torch.utils import limbs as hl

DEFAULT_WINDOW = 4


def _tensor(a, device):
    """Host numpy/ints -> contiguous int64 tensor on device."""
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64), device=device)


class MontgomeryContext(NamedTuple):
    """Per-modulus constants, int64 [L] canonical limbs each.

    m: the modulus M; m_prime: M' = -M^-1 mod R; r2: R^2 mod M (the
    to-Montgomery factor); one: R mod M (Montgomery 1); m_comp: R - M (the
    branch-free conditional subtract).

    The int8 REDC matrices that phe_tpu's context carries as fields ride
    beside it, on the host: ``redc_matrices(ctx)`` returns the ones
    ``interop.montgomery_context`` carried across from phe_tpu, or builds
    them. Both limb kernels (csrc/mont_pow.cu, csrc/mont_mul.cu) read them,
    packed once per context on its card (cuda_modexp._pow_columns).
    """

    m: torch.Tensor
    m_prime: torch.Tensor
    r2: torch.Tensor
    one: torch.Tensor
    m_comp: torch.Tensor

    @property
    def num_limbs(self):
        return self.m.shape[-1]


def num_limbs_for_modulus(modulus_bits):
    """L such that R = 2**(14 L) >= 2**16 * M, rounded up to a multiple of 8."""
    raw = -(-(modulus_bits + 16) // lm.LIMB_BITS)
    return -(-raw // 8) * 8


def build_context(modulus, device, num_limbs=None):
    """Host-side construction of a MontgomeryContext from a Python int.

    Its REDC matrices are built at its first int8-body launch, at every L.
    """
    if num_limbs is None:
        num_limbs = num_limbs_for_modulus(modulus.bit_length())
    R = 1 << (lm.LIMB_BITS * num_limbs)
    if R < (modulus << 16):
        raise ValueError("num_limbs too small for subtraction-free Montgomery")
    m_prime = (-pow(modulus, -1, R)) % R
    pack = lambda v: _tensor(hl.int_to_limbs(v, num_limbs), device)
    return MontgomeryContext(
        m=pack(modulus),
        m_prime=pack(m_prime),
        r2=pack(R * R % modulus),
        one=pack(R % modulus),
        m_comp=pack(R - modulus),
    )


class RedcMatrices(NamedTuple):
    """phe_tpu's int8 REDC matrices for one modulus (montgomery.py
    _build_redc_matrices), turning both constant products of Montgomery's
    reduction into digit matmuls.

    w_mq: int8 [2L, 2L]; row k is output digit k of q = T_lo M' mod R in
      block order (rows [0, L) the low 7 bits of limb k, [L, 2L) the high
      7 bits), column i input digit i in the same order: the digits of
      (2^w_i M') mod R, w_i = 14 i or 14 (i - L) + 7.
    w_m: int8 [4L, 2L], the same for q M over 2L output limbs.
    c_mq, c_m: int64 [2L], [4L]: 64 times the high-digit columns' sums. The
      input's high digits are carried biased by -64 (a limb of exactly
      2^14 has a high digit of 128, past int8), and the vectors restore
      the exact sums.
    """

    w_mq: torch.Tensor
    w_m: torch.Tensor
    c_mq: torch.Tensor
    c_m: torch.Tensor


# Per context, keyed by its m tensor: the RedcMatrices carried across from
# phe_tpu, on the host.
_carried = WeakIdKeyDictionary()


def build_redc_matrices(modulus, num_limbs, device):
    """RedcMatrices for M = modulus at L = num_limbs, array-equal to
    phe_tpu's _build_redc_matrices wherever that accepts L (L <= 507).

    phe_tpu refuses L > 507 because its kernel forms uint32 slots
    lo + (hi << 7) before a carry fix; the CUDA kernel recombines in 64
    bits, and the matmul's own int32 sums stay below 2L * 127 * 128
    (3.8e7 at L = 1,176), so every L is accepted here. The rows are
    shifted copies of M's and M''s limbs, so no per-entry Python int is
    formed.
    """
    L = num_limbs
    R = 1 << (lm.LIMB_BITS * L)
    m_prime = (-pow(modulus, -1, R)) % R
    mp = hl.int_to_limbs(m_prime, L)
    mp7 = hl.int_to_limbs((m_prime << 7) % R, L)
    m = hl.int_to_limbs(modulus, 2 * L)
    m7 = hl.int_to_limbs(modulus << 7, 2 * L)
    q_rows = np.zeros((2 * L, L), np.uint32)
    m_rows = np.zeros((2 * L, 2 * L), np.uint32)
    for i in range(L):
        q_rows[i, i:] = mp[: L - i]
        q_rows[L + i, i:] = mp7[: L - i]
        m_rows[i, i:] = m[: 2 * L - i]
        m_rows[L + i, i:] = m7[: 2 * L - i]
    # Input digit i's row -> the block-order digits of its constant.
    a_q = np.concatenate([q_rows & 0x7F, q_rows >> 7], axis=1)
    a_m = np.concatenate([m_rows & 0x7F, m_rows >> 7], axis=1)
    c_q = 64 * a_q[L:].sum(axis=0, dtype=np.int64)
    c_m = 64 * a_m[L:].sum(axis=0, dtype=np.int64)
    i8 = lambda a: torch.as_tensor(np.ascontiguousarray(a.T.astype(np.int8)),
                                   device=device)
    return RedcMatrices(w_mq=i8(a_q), w_m=i8(a_m), c_mq=_tensor(c_q, device),
                        c_m=_tensor(c_m, device))


def redc_matrices(ctx):
    """The context's RedcMatrices on the host: the ones carried across
    from phe_tpu, else built from M's limbs. No built copy is kept: the
    modexp's wrapper keeps only its packed operands."""
    mats = _carried.get(ctx.m)
    if mats is None:
        modulus = hl.limbs_to_int(ctx.m.cpu().numpy())
        mats = build_redc_matrices(modulus, ctx.num_limbs, "cpu")
    return mats


def attach_redc_matrices(ctx, mats):
    """Keep mats (carried across from phe_tpu) as the context's own."""
    _carried[ctx.m] = mats


def redc(t, ctx):
    """Montgomery reduction: value(t) * R^-1 mod M, redundant limbs.

    t: [..., W] with W >= 2L and value < c*R*M (c a small constant).
    Output [..., W-L] with value < (c + 1.01) * M. This is the plain
    PyTorch version of the kernel's reduction.
    """
    L = ctx.num_limbs
    W = t.shape[-1]
    m_q = lm.mul_low(t, ctx.m_prime.expand(t.shape[:-1] + (L,)), L)
    mm = lm.mul_full(m_q, ctx.m.expand(m_q.shape))  # [..., 2L]
    if W > 2 * L:
        mm = F.pad(mm, (0, W - 2 * L))
    return lm.shift_right_limbs_exact(lm.add(t, mm), L)


def mont_mul(a, b, ctx):
    """Montgomery product a*b*R^-1 mod M over [B, L] operands (< 1.01 M)."""
    from phe_tpu_torch.ops import cuda_modexp

    return cuda_modexp.mont_mul(a.contiguous(), b.contiguous(), ctx)


def mont_mul_const(a, b_limbs, ctx):
    """Montgomery product against one shared [L] operand: a*b*R^-1 mod M."""
    from phe_tpu_torch.ops import cuda_modexp

    return cuda_modexp.mont_mul_const(a.contiguous(), b_limbs.contiguous(), ctx)


def mont_mul_plain(a, b, ctx):
    """Plain PyTorch Montgomery product: a [B, L], b [B, L] or [L]."""
    return redc(lm.mul_full(a, b.expand(a.shape)), ctx)


def _windowed_table(base, ctx, window):
    """Powers table [2^w, B, L]: table[j] = base^j in Montgomery form."""
    one = ctx.one.expand(base.shape)
    table = [one]
    for _ in range(2**window - 1):
        table.append(mont_mul_plain(table[-1], base, ctx))
    return torch.stack(table)


def mont_pow_shared_plain(base, digits, ctx, window=DEFAULT_WINDOW):
    """Plain version of the shared-exponent limb-engine modexp kernel.

    base: [B, L] Montgomery-domain values (< 2.01 M); digits: [n_windows]
    MSB-first base-2^window digits of e. Returns [B, L] congruent to
    base^e R mod M, < 1.01 M: phe_tpu's _mont_pow_shared_xla, with the
    product's plain version.
    """
    table = _windowed_table(base, ctx, window)
    acc = ctx.one.expand(base.shape)
    for digit in np.asarray(torch.as_tensor(digits).cpu()).tolist():
        for _ in range(window):
            acc = mont_mul_plain(acc, acc, ctx)
        acc = mont_mul_plain(acc, table[digit], ctx)
    return acc


def mont_pow_plain(base, digits, ctx, window=DEFAULT_WINDOW):
    """Plain version of the per-element limb-engine modexp kernel.

    base: [B, L]; digits: [B, n_windows], one schedule per row (a host
    array or tensor, any integer type). phe_tpu's _mont_pow_xla: the
    one-hot table select picks exactly table[d] per row.
    """
    table = _windowed_table(base, ctx, window)
    digits = torch.as_tensor(digits).to(device=base.device, dtype=torch.int64)
    rows = torch.arange(base.shape[0], device=base.device)
    acc = ctx.one.expand(base.shape)
    for wi in range(digits.shape[-1]):
        for _ in range(window):
            acc = mont_mul_plain(acc, acc, ctx)
        acc = mont_mul_plain(acc, table[digits[:, wi], rows], ctx)
    return acc


def mont_pow_shared(base, digits, ctx, window=DEFAULT_WINDOW):
    """base^e in Montgomery form, one exponent shared across the batch.

    base: [B, L] Montgomery-domain bases; digits: [n_windows]. The CUDA
    kernel for tensors on the card, mont_pow_shared_plain on the CPU
    (cuda_modexp.mont_pow_shared).
    """
    from phe_tpu_torch.ops import cuda_modexp

    return cuda_modexp.mont_pow_shared(base.contiguous(), digits, ctx,
                                       window=window)


def mont_pow(base, digits, ctx, window=DEFAULT_WINDOW):
    """base_i^e_i in Montgomery form, per-element exponents.

    base: [..., L]; digits: [..., n_windows] with matching leading dims,
    flattened for the kernel (cuda_modexp.mont_pow).
    """
    from phe_tpu_torch.ops import cuda_modexp

    digits = torch.as_tensor(digits)
    lead = base.shape[:-1]
    out = cuda_modexp.mont_pow(
        base.reshape(-1, base.shape[-1]).contiguous(),
        digits.reshape(-1, digits.shape[-1]), ctx, window=window)
    return out.reshape(lead + (base.shape[-1],))


def to_mont(x, ctx):
    """Enter the Montgomery domain: x -> x*R mod M, for [B, L] inputs.

    The kernel-branch formulation: one shared-operand product x * R^2.
    """
    if x.shape[-1] != ctx.num_limbs:
        raise ValueError(
            "to_mont takes exactly L = %d limbs, got %d"
            % (ctx.num_limbs, x.shape[-1])
        )
    return mont_mul_const(x, ctx.r2, ctx)


def from_mont(x, ctx):
    """Leave the Montgomery domain: x*R -> x mod M (redundant, < 1.01 M).

    The kernel-branch formulation: a shared-operand product by the integer 1.
    """
    one_int = F.pad(torch.ones_like(ctx.m[:1]), (0, ctx.num_limbs - 1))
    return mont_mul_const(x, one_int, ctx)


def export_canonical(x, ctx):
    """Boundary helper: redundant value < 2M -> canonical limbs in [0, M)."""
    return lm.cond_sub(lm.normalize(x), ctx.m_comp, ctx.num_limbs)


class ExcessReducer(NamedTuple):
    """Constants for reduce_excess: v <= 2^10 * M -> [0, M).

    With s = bits(M) - 4: a = floor(v / 2^s) < 2^14 and
    mu = floor(2^18 * 2^s / M) in (2^14, 2^15], so a*mu < 2^29 and
    j~ = (a * mu) >> 18 satisfies floor(v/M) - 2 <= j~ <= floor(v/M).
    Subtracting j~*M via the radix complement leaves v' in [0, 3M); a
    conditional subtract of 2M then M lands canonical in [0, M).
    i0 = s // 14 and r = s % 14 locate bit s.
    """

    mu: torch.Tensor  # [1]: floor(2^18 * 2^s / M)
    comp1: torch.Tensor  # [W] canonical limbs of 2^(14 W) - M
    comp2: torch.Tensor  # [W] canonical limbs of 2^(14 W) - 2M
    i0: int
    r: int

    @property
    def in_limbs(self):
        return self.comp1.shape[0]


def build_excess_reducer(modulus, in_limbs, device):
    """Host-side constants for reduce_excess over in_limbs-wide inputs."""
    M = int(modulus)
    s = M.bit_length() - 4
    W = in_limbs
    R_w = 1 << (lm.LIMB_BITS * W)
    if not 2 * M < R_w:
        raise ValueError("input width too narrow for the 2M complement")
    return ExcessReducer(
        mu=_tensor([(1 << 18 << s) // M], device),
        comp1=_tensor(hl.int_to_limbs(R_w - M, W), device),
        comp2=_tensor(hl.int_to_limbs(R_w - 2 * M, W), device),
        i0=s // lm.LIMB_BITS,
        r=s % lm.LIMB_BITS,
    )


def reduce_excess(v, red):
    """Reduce canonical limbs [..., W], value <= 2^10 * M, to [0, M)."""
    i0, r = red.i0, red.r
    W = red.in_limbs
    # a = floor(v / 2^s) < 2^14: spans limbs i0 (from bit r) and i0+1.
    a = v[..., i0] >> r
    if i0 + 1 < W and r:
        a = a + (v[..., i0 + 1] << (lm.LIMB_BITS - r))
    jt = (a * red.mu[0]) >> 18  # floor(v/M) - 2 <= jt <= floor(v/M)
    # v - jt*M via the radix complement: slot products < 2^28, one
    # normalize ripples every carry and drops the jt * 2^(14 W) excess.
    v1 = lm.normalize(v + jt[..., None] * red.comp1)  # < 3M, canonical
    v2 = lm.cond_sub(v1, red.comp2, W)  # < 2M
    return lm.cond_sub(v2, red.comp1, W)  # < M, canonical


def exponent_digits(exponent, exponent_bits, window=DEFAULT_WINDOW):
    """Host helper: fixed-width base-2**window digits, MSB first (int64)."""
    n_windows = -(-exponent_bits // window)
    mask = (1 << window) - 1
    return np.array(
        [(exponent >> (window * i)) & mask for i in reversed(range(n_windows))],
        dtype=np.int64,
    )


class ConstMulTable(NamedTuple):
    """Digit-matmul constants for a limb product with a shared constant.

    w: int8 [3*in_limbs, 2*out_limbs] — the three 6-bit input-plane blocks
    stacked, each split into lo-7 | hi-7 bit column halves.
    """

    w: torch.Tensor

    @property
    def out_limbs(self):
        return self.w.shape[1] // 2


def build_const_mul(const_value, in_limbs, out_limbs, device):
    """ConstMulTable for (a * const) mod 2^(14*out_limbs).

    Exact for inputs with limbs <= 2^16: digit planes are < 64, matmul
    sums run over 3*in_limbs terms of 63*127 < 2^13, and the recombined
    slots c0 + (c1 << 7) stay under 2^31 (carry_fix's bound) for
    in_limbs <= 698.
    """
    if in_limbs > 698:
        raise ValueError(
            "const_mul accumulator bound holds for <= 698 input limbs"
        )
    c = int(const_value)
    blocks = []
    for w in (0, 6, 12):
        sl = hl.int_to_limbs((c << w) & ((1 << (14 * out_limbs)) - 1),
                             out_limbs)
        M = np.zeros((in_limbs, out_limbs), np.uint32)
        for i in range(in_limbs):
            M[i, i:] = sl[: out_limbs - i]
        blocks.append(M)
    Mall = np.concatenate(blocks, axis=0)  # [3*in, out], entries < 2^14
    w8 = np.concatenate(
        [(Mall & 0x7F).astype(np.int8), (Mall >> 7).astype(np.int8)], axis=1
    )
    return ConstMulTable(w=torch.as_tensor(np.ascontiguousarray(w8), device=device))


def _planes6(a):
    """Limbs <= 2^16 -> their three 6-bit digit planes, concatenated."""
    return torch.cat([a & 0x3F, (a >> 6) & 0x3F, a >> 12], dim=-1)


def const_mul(a, table):
    """(a * const) mod 2^(14*out_limbs) -> redundant limbs [..., out].

    a: [..., in_limbs] limbs <= 2^16. Digit sums are < 3 * 698 * 63 * 127
    < 2^24: matmul_exact is exact.
    """
    out = lm.matmul_exact(_planes6(a), table.w)
    O = table.out_limbs
    return lm.carry_fix(out[..., :O] + (out[..., O:] << 7))


class ReduceTable(NamedTuple):
    """Constants for reducing wide values mod M: powers beta^(L+j) mod M.

    powers: [K, L] canonical limbs of 2**(14*(L+j)) mod M.
    digit_w: int8 [3K, 2(L+1)] digit matrix of the wide fold: rows are the
      lo-7 | hi-7 digit blocks of the limbs of 2**w * (beta^(L+j) mod M) for
      w in (0, 6, 12), j-major within each w plane.
    """

    powers: torch.Tensor
    digit_w: torch.Tensor


# The wide fold's slots are low + c0 + (c1 << 7) with c0, c1 each a sum
# over K rows of (63 + 63 + 16) * 127 (three 6-bit planes of a limb
# <= 2^16 times 7-bit matrix digits): 2^16 + 129 * 18034 K < 2^31 holds
# for K <= 923, the ceiling of carry_fix's three-pass soundness.
# phe_tpu accepts any K >= 8 there; the port refuses past the bound.
MAX_FOLD_LIMBS = 900


def build_reduce_table(modulus, ctx, in_limbs, device):
    """Host-side table for mod_reduce of in_limbs-wide inputs."""
    L = ctx.num_limbs
    K = in_limbs - L
    if K <= 0:
        raise ValueError("input is not wider than the modulus context")
    if K > MAX_FOLD_LIMBS:
        raise ValueError(
            "mod_reduce fold of %d over-limbs exceeds the carry bound "
            "(max %d)" % (K, MAX_FOLD_LIMBS)
        )
    rows = [
        hl.int_to_limbs(pow(1 << lm.LIMB_BITS, L + j, modulus), L)
        for j in range(K)
    ]
    wrows = np.stack([
        hl.int_to_limbs(pow(1 << lm.LIMB_BITS, L + j, modulus) << w, L + 1)
        for w in (0, 6, 12)
        for j in range(K)
    ]).astype(np.uint32)
    digit_w = np.concatenate(
        [(wrows & 0x7F).astype(np.int8), (wrows >> 7).astype(np.int8)],
        axis=1,
    )
    return ReduceTable(
        powers=_tensor(np.stack(rows), device),
        digit_w=torch.as_tensor(np.ascontiguousarray(digit_w), device=device),
    )


def mod_reduce(x, ctx, table):
    """Partially reduce a wide value: [..., Lx] -> [..., L+1], value < 1.51*R.

    Folds every limb above position L through the precomputed
    beta^(L+j) mod M powers, twice (the second fold sees at most two
    over-limbs). The wide fold is one exact int8-digit matmul; narrow
    folds (K < 8) multiply-accumulate the 6-bit parts against the powers.
    """
    L = ctx.num_limbs

    def fold(v):
        low = v[..., :L]
        high = v[..., L:]  # [..., K] limbs <= 2**16
        K = high.shape[-1]
        if K > MAX_FOLD_LIMBS:
            raise ValueError(
                "mod_reduce fold of %d over-limbs exceeds the carry bound "
                "(max %d)" % (K, MAX_FOLD_LIMBS)
            )
        if 3 * K == table.digit_w.shape[0] and K >= 8:
            # Digit sums: 3K terms of 63 * 127 < 2^25 for K <= 900.
            out = lm.matmul_exact(_planes6(high), table.digit_w)
            c0, c1 = out[..., : L + 1], out[..., L + 1 :]
            return lm.carry_fix(F.pad(low, (0, 1)) + c0 + (c1 << 7))
        acc = F.pad(low, (0, 1))  # [..., L+1]
        powers = table.powers[:K]
        for w in (0, 6, 12):
            part = (high >> w) & 0x3F if w < 12 else high >> 12
            s = (part[..., :, None] * powers).sum(dim=-2)  # [..., L] < 2**30
            acc = acc + F.pad((s & lm.LIMB_MASK) << w, (0, 1))
            acc = acc + F.pad((s >> lm.LIMB_BITS) << w, (1, 0))
        return lm.carry_fix(acc)  # [..., L+1]

    y = fold(x)  # value <= beta^L(1+eps) + K*2**16*M <= 2**8 * R
    return fold(y)  # value <= beta^L(1+eps) + 2**16*M < 1.51 * R
