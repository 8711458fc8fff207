"""RNS (Cox-Rower residue number system) Montgomery arithmetic in PyTorch.

The PyTorch counterpart of phe_tpu/ops/rns.py: the host-side system
builder, the residue conversions, one fused tau-domain Montgomery product,
and the plain versions of the two ladders (shared and per-element
exponent) that the CUDA kernel (phe_tpu_torch/csrc/rns_ladder.cu)
computes. phe_tpu/ops/rns.py's module docstring derives the algorithm and
every bound; this port keeps the same channel primes, constants and
staging, so every residue it produces is the same integer as the
reference's.

In short: a value x < 2kN lives as its residues modulo 2k + 1 distinct
14-bit primes (base A, base B, one redundant channel m_r), with 7 replica
rows of m_r padding the channel axis to cpad = 2k + 8. One Montgomery
product is an elementwise channel product, a Barrett reduction, and two
base extensions, each an int8 digit matmul against a constant matrix
(w_ext1, w_ext2, [3(k+8), 2k]), with the Shenoy-Kumaresan beta from the
redundant channel making the second extension exact. Base-B residues are
stored pre-multiplied by c_tau (the tau domain), which folds a step away.

Residues travel as int64 tensors [..., cpad]; every intermediate stays
below 2^31, so int64 computes the same integers as the uint32 reference.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from phe_tpu_torch.ops import limb_math as lm
from phe_tpu_torch.ops import montgomery as mg
from phe_tpu_torch.utils import limbs as hl

DEFAULT_WINDOW = 4
_SPARE = 8  # channel rows past 2k: [r, r replicas] so the axis tiles
# Channel-prime floor: the smallest modulus for which the steps=3 Barrett
# conditional-subtract ladder covers the quotient error at every call site
# (phe_tpu/ops/rns.py derives it). Primes in (M_MIN, 2^14): 1,335.
M_MIN = 4099


class RNSSystem(NamedTuple):
    """Host-built constants for one modulus N, as tensors on one device.

    Channel layout (cpad = 2k + 8 rows): [0:k] base A, [k:2k] base B,
    [2k] the redundant channel m_r, [2k+1:] replicas of m_r (padding; they
    compute duplicate values and are never read).
    """

    # per-channel vectors [cpad] int64
    m: torch.Tensor  # channel moduli
    mu: torch.Tensor  # floor(2^28 / m)
    t14: torch.Tensor  # 2^14 mod m
    sig1: torch.Tensor  # A rows: c_sigma = -N^-1 (M_A/a_i)^-1 mod a_i; 0 else
    sig2: torch.Tensor  # A rows: 2^14 c_sigma mod a_i; 0 elsewhere
    d1: torch.Tensor  # B u r rows: M_A^-1 scale^-1 mod m_j; 0 elsewhere
    d2: torch.Tensor  # B u r rows: 2^14 d1 mod m_j; 0 elsewhere
    e1: torch.Tensor  # B u r rows: N M_A^-1 scale mod m_j; 0 elsewhere
    scale: torch.Tensor  # tau-domain scale: c_tau on B rows, 1 on A u r;
    #   also the stored representation of the integer 1's residues
    neg_mb: torch.Tensor  # A rows: (-M_B) mod a_i; 0 elsewhere
    one_dom: torch.Tensor  # stored residues of M_A mod N (Mont-domain 1)
    r2_dom: torch.Tensor  # stored residues of M_A^2 mod N (entry factor)
    w_r: torch.Tensor  # B rows: (M_B/b_j) mod m_r (from_rns beta row)

    # scalars as [1] int64
    mbinv_r: torch.Tensor  # M_B^-1 mod m_r
    m_r: torch.Tensor
    mu_r: torch.Tensor

    # int8 digit-block matrices ([3K, 2C] layout, see _digit_blocks)
    w_ext1: torch.Tensor  # [3(k+8), 2k]: (M_A/a_i) mod m_j, j in B u r u pads
    w_ext2: torch.Tensor  # [3(k+8), 2k]: (M_B/b_j) mod m_i, i in A u r u pads
    w_out: torch.Tensor  # [3*out_limbs, 2k]: limbs of (M_B/b_j)
    neg_mb_limbs: torch.Tensor  # [out_limbs]: (2^(14 out_limbs) - M_B) limbs

    @property
    def cpad(self):
        return self.m.shape[0]

    @property
    def k(self):
        return (self.cpad - _SPARE) // 2

    @property
    def out_limbs(self):
        return self.neg_mb_limbs.shape[0]


@functools.cache
def _channel_supply():
    """Every prime in [M_MIN, 2^14), descending: the channel moduli."""
    top = 1 << 14
    sieve = np.ones(top, dtype=bool)
    sieve[:2] = False
    for i in range(2, int(top**0.5) + 1):
        if sieve[i]:
            sieve[i * i :: i] = False
    return tuple(int(p) for p in np.nonzero(sieve)[0][::-1] if p >= M_MIN)


def _digit_blocks(entries):
    """[K, C] canonical < 2^14 -> int8 numpy [3K, 2C] block matrix.

    Against an input digit stack [x_lo; x_hi] the three output blocks are
    c0 = lo@x_lo, c1 = hi@x_lo + lo@x_hi, c2 = hi@x_hi, so that
    value = c0 + 2^7 c1 + 2^14 c2 exactly.
    """
    e = np.asarray(entries, dtype=np.uint32)
    lo = (e & 0x7F).astype(np.int8)
    hi = (e >> 7).astype(np.int8)
    z = np.zeros_like(lo)
    return np.block([[lo, z], [hi, lo], [z, hi]])


@functools.lru_cache(maxsize=64)
def _channel_plan(N, max_entry_bits):
    """(k, A, B, m_r, M_A, M_B) for modulus N, or None past the supply;
    cached, so ``fits`` and then ``build_rns`` plan a modulus once."""
    entry_floor = (1 << max_entry_bits) if max_entry_bits else 0
    supply = _channel_supply()
    k = max(8, -(-(N.bit_length() + 24) // 14))
    while True:
        k = -(-k // 8) * 8
        if 2 * k + 1 > len(supply) or k > 1000:
            return None
        primes = supply[: 2 * k + 1]
        A, B, m_r = primes[0 : 2 * k : 2], primes[1 : 2 * k : 2], primes[2 * k]
        M_A = M_B = 1
        for a in A:
            M_A *= a
        for b in B:
            M_B *= b
        need = max(4 * k * N, -(-entry_floor // k))
        if M_A >= need and M_B >= 4 * k * N:
            return k, A, B, m_r, M_A, M_B
        k += 8


def fits(modulus, max_entry_bits=None):
    """Whether the channel-prime supply covers modulus N (build_rns's
    condition): moduli up to ~8,760 bits, keys up to ~4,380 bits for n^2.
    Past it the modexps run on the limb engine (batch.py)."""
    return _channel_plan(int(modulus), max_entry_bits) is not None


def _channels(modulus, max_entry_bits=None):
    """(k, A, B, m_r, M_A, M_B): the channel primes for modulus N.

    The general product bound is x*y <= k*N*M_A; chained operands <= 2kN
    need M_A >= 4kN. ``max_entry_bits`` additionally sizes M_A for a wider
    first operand. Past the supply of primes in [M_MIN, 2^14) (moduli
    above ~8,760 bits) or the digit-combine cap k <= 1000 this raises
    ValueError, as phe_tpu's build_rns does; callers ask ``fits`` first.
    """
    plan = _channel_plan(int(modulus), max_entry_bits)
    if plan is None:
        raise ValueError(
            "a %d-bit modulus exceeds the [%d, 2^14) RNS channel supply"
            % (int(modulus).bit_length(), M_MIN)
        )
    return plan


def build_rns(modulus, device, max_entry_bits=None):
    """Construct the RNS system for one modulus N (host, Python ints)."""
    N = int(modulus)
    k, A, B, m_r, M_A, M_B = _channels(N, max_entry_bits)
    cpad = 2 * k + _SPARE
    chans = A + B + (m_r,) * _SPARE
    marr = np.array(chans, dtype=np.int64)

    ninv = pow(N, -1, M_A)
    sig1 = np.zeros(cpad, np.int64)
    sig2 = np.zeros(cpad, np.int64)
    for i, a in enumerate(A):
        cs = (-ninv * pow(M_A // a, -1, a)) % a
        sig1[i] = cs
        sig2[i] = (cs << 14) % a

    scale = np.ones(cpad, np.int64)
    for j, b in enumerate(B):
        scale[k + j] = pow(M_B // b, -1, b)

    d1 = np.zeros(cpad, np.int64)
    d2 = np.zeros(cpad, np.int64)
    e1 = np.zeros(cpad, np.int64)
    for j in range(k, cpad):
        mj = chans[j]
        inv = pow(M_A % mj, -1, mj)
        s = int(scale[j])
        d1[j] = inv * pow(s, -1, mj) % mj
        d2[j] = (int(d1[j]) << 14) % mj
        e1[j] = (N % mj) * inv % mj * s % mj

    neg_mb = np.zeros(cpad, np.int64)
    for i, a in enumerate(A):
        neg_mb[i] = (-M_B) % a

    # Domain constants are the reduced representatives (< N), stored in
    # the tau domain (per-channel residue times scale).
    one_int = M_A % N
    one_dom = [one_int % m * int(s) % m for m, s in zip(chans, scale)]
    r2int = M_A * M_A % N
    r2_dom = [r2int % m * int(s) % m for m, s in zip(chans, scale)]

    ma_over = [M_A // a for a in A]
    mb_over = [M_B // b for b in B]
    w1 = np.array([[q % mj for q in ma_over] for mj in chans[k:]], np.uint32)
    out_rows = A + (m_r,) * _SPARE
    w2 = np.array([[q % mi for q in mb_over] for mi in out_rows], np.uint32)

    out_limbs = hl.num_limbs_for_bits(M_B.bit_length())
    vout = np.zeros((out_limbs, k), np.uint32)
    for j, q in enumerate(mb_over):
        vout[:, j] = hl.int_to_limbs(q, out_limbs)
    w_r = np.zeros(cpad, np.int64)
    for j, q in enumerate(mb_over):
        w_r[k + j] = q % m_r
    r_out = 1 << (lm.LIMB_BITS * out_limbs)

    t = lambda a: mg._tensor(a, device)
    i8 = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return RNSSystem(
        m=t(marr),
        mu=t((1 << 28) // marr),
        t14=t((1 << 14) % marr),
        sig1=t(sig1),
        sig2=t(sig2),
        d1=t(d1),
        d2=t(d2),
        e1=t(e1),
        scale=t(scale),
        neg_mb=t(neg_mb),
        one_dom=t(one_dom),
        r2_dom=t(r2_dom),
        w_r=t(w_r),
        mbinv_r=t([pow(M_B % m_r, -1, m_r)]),
        m_r=t([m_r]),
        mu_r=t([(1 << 28) // m_r]),
        w_ext1=i8(_digit_blocks(w1)),
        w_ext2=i8(_digit_blocks(w2)),
        w_out=i8(_digit_blocks(vout)),
        neg_mb_limbs=t(hl.int_to_limbs(r_out - M_B, out_limbs)),
    )


class RNSConversion(NamedTuple):
    """Binary->RNS matrix for one input width, with bias compensation.

    w: int8 [3*cpad, 2*in_limbs] digit-block matrix of 2^(14 j) mod m_c
      (times the channel's tau-domain scale).
    comp: int64 [3*cpad] compensation restoring exact sums when input high
      digits are biased by -64 (redundant limbs reach 2^14, whose raw high
      digit 128 exceeds int8).
    """

    w: torch.Tensor
    comp: torch.Tensor


def build_conversion(system, in_limbs):
    """Conversion constants: binary limbs (redundant OK) -> all channels."""
    m_np = system.m.cpu().numpy()
    s_np = system.scale.cpu().numpy()
    w = np.zeros((system.cpad, in_limbs), np.uint32)
    for c in range(system.cpad):
        mc, sc = int(m_np[c]), int(s_np[c])
        w[c] = [
            pow(1 << lm.LIMB_BITS, j, mc) * sc % mc for j in range(in_limbs)
        ]
    blocks = _digit_blocks(w)
    comp = 64 * blocks[:, in_limbs:].astype(np.int64).sum(axis=1)
    dev = system.m.device
    return RNSConversion(
        w=torch.as_tensor(np.ascontiguousarray(blocks), device=dev),
        comp=mg._tensor(comp, dev),
    )


def residues(value, sys_):
    """Stored (tau-domain) residues of a host integer: int64 [cpad]."""
    v = int(value)
    m_np = sys_.m.cpu().numpy()
    s_np = sys_.scale.cpu().numpy()
    return mg._tensor(
        [v % int(mc) * int(sc) % int(mc) for mc, sc in zip(m_np, s_np)],
        sys_.m.device,
    )


def _mod(x, m, mu):
    """Barrett: x < 2^30 -> x mod m, canonical (steps=3 ladder: 4m, 2m, m)."""
    q = ((x >> 14) * mu) >> 14
    r = x - q * m
    for s in (2, 1, 0):
        step = m << s
        r = torch.where(r >= step, r - step, r)
    return r


def _digits_i8(x):
    """Canonical values < 2^14 [..., C] -> int8 [..., 2C] (lo then hi)."""
    return torch.cat([x & 0x7F, x >> 7], dim=-1).to(torch.int8)


def _block_matmul(w, dig):
    """w [3K, 2C] int8, dig [..., 2C] int8 -> (c0, c1, c2) int64 [..., K].

    Digit sums span <= 2k <= 2000 terms of <= 127^2 < 2^25: exact.
    """
    out = lm.matmul_exact(dig, w.t())  # [..., 3K]
    K = w.shape[0] // 3
    return out[..., :K], out[..., K : 2 * K], out[..., 2 * K :]


def _combine_raw(c0, c1, c2, m, mu, t14):
    """c0 + 2^7 c1 + 2^14 c2, one Barrett short of canonical (< 2^28.2)."""
    e = _mod(c2 + (c1 >> 7), m, mu)
    return c0 + ((c1 & 0x7F) << 7) + e * t14


def _combine_mod(c0, c1, c2, m, mu, t14):
    """(c0 + 2^7 c1 + 2^14 c2) mod m for digit sums c* < 2^24."""
    return _mod(_combine_raw(c0, c1, c2, m, mu, t14), m, mu)


def rns_mont_mul(x, y, sys_):
    """One RNS Montgomery product over [..., cpad] stored-residue tensors.

    In/out canonical stored residues; represented values <= 2kN in and
    out. Fused tau-domain staging: the raw 28-bit channel product is split
    h*2^14 + l and consumed directly by the sigma / REDC constant
    multiplies.
    """
    k = sys_.k
    m, mu = sys_.m, sys_.mu
    raw = x * y  # < m^2 < 2^28, never canonicalised
    h = raw >> 14
    l = raw & 0x3FFF
    sigma = _mod(
        h[..., :k] * sys_.sig2[:k] + l[..., :k] * sys_.sig1[:k], m[:k], mu[:k]
    )
    # Extension 1 -> q^ on B u r u pads.
    c0, c1, c2 = _block_matmul(sys_.w_ext1, _digits_i8(sigma))
    mj, muj, t14j = m[k:], mu[k:], sys_.t14[k:]
    qhat = _combine_mod(c0, c1, c2, mj, muj, t14j)  # [..., k+8]
    u_br = _mod(
        h[..., k:] * sys_.d2[k:] + l[..., k:] * sys_.d1[k:] + qhat * sys_.e1[k:],
        mj, muj,
    )
    # Extension 2 -> S on A u r u pads; exact beta via the redundant row.
    c0, c1, c2 = _block_matmul(sys_.w_ext2, _digits_i8(u_br[..., :k]))
    mi = torch.cat([m[:k], m[2 * k :]])
    mui = torch.cat([mu[:k], mu[2 * k :]])
    t14i = torch.cat([sys_.t14[:k], sys_.t14[2 * k :]])
    S_raw = _combine_raw(c0, c1, c2, mi, mui, t14i)  # [..., k+8], < 2^28.2
    u_r = u_br[..., k : k + 1]  # channel r sits at index k of the B u r block
    S_r = _mod(S_raw[..., k : k + 1], sys_.m_r, sys_.mu_r)
    beta = _mod((S_r + (sys_.m_r - u_r)) * sys_.mbinv_r, sys_.m_r, sys_.mu_r)
    u_a = _mod(S_raw[..., :k] + beta * sys_.neg_mb[:k], m[:k], mu[:k])
    return torch.cat([u_a, u_br], dim=-1)


def to_rns(limbs, conv, sys_):
    """Binary limbs [..., Lin] (redundant <= 2^14 OK) -> [..., cpad].

    High digits are biased into int8 range and compensated after the
    matmul; digit sums are < 2 Lin 2^14 < 2^24.
    """
    dig = torch.cat([limbs & 0x7F, (limbs >> 7) - 64], dim=-1).to(torch.int8)
    out = lm.matmul_exact(dig, conv.w.t()) + conv.comp
    C = sys_.cpad
    return _combine_mod(
        out[..., :C], out[..., C : 2 * C], out[..., 2 * C :],
        sys_.m, sys_.mu, sys_.t14,
    )


def from_rns(u, sys_):
    """Exact canonical binary limbs of u < M_B from [..., cpad] residues.

    S = sum_j tau_j (M_B/b_j) lands as limb slots via the w_out digit
    matmul; the Shenoy-Kumaresan beta (from the redundant channel) then
    removes the beta*M_B excess using the radix complement.
    """
    k = sys_.k
    tau = u[..., k : 2 * k]
    c0, c1, c2 = _block_matmul(sys_.w_out, _digits_i8(tau))
    # Slots c0 + 2^7 c1 + 2^14 c2, the 2^14-scale parts one limb up: < 2^25.1.
    slots = c0 + ((c1 & 0x7F) << 7) + lm._shift_up((c1 >> 7) + c2)
    terms = _mod(tau * sys_.w_r[k : 2 * k], sys_.m_r, sys_.mu_r)
    s_r = _mod(terms.sum(dim=-1, keepdim=True), sys_.m_r, sys_.mu_r)
    u_r = u[..., 2 * k : 2 * k + 1]
    beta = _mod((s_r + (sys_.m_r - u_r)) * sys_.mbinv_r, sys_.m_r, sys_.mu_r)
    slots = slots + beta * sys_.neg_mb_limbs  # + beta (R_out - M_B)
    # Full normalisation: every carry rippled out of the top removes
    # exactly beta * R_out.
    return lm.normalize(slots)


def rns_pow_digits(exponent, exponent_bits, window=DEFAULT_WINDOW):
    """Host helper: MSB-first digit schedule (same as montgomery's)."""
    return mg.exponent_digits(exponent, exponent_bits, window)


def ladder_plain(x_res, digits, sys_, window=DEFAULT_WINDOW, exit_res=None,
                 entry_res=None):
    """Plain PyTorch version of the ladder kernel: residues in, residues out.

    x_res: [B, cpad] stored residues of values < 2kN; digits: [n_windows]
    MSB-first base-2^window digits of the shared exponent e (a host array
    or tensor). Returns [B, cpad] residues of (x F)^e E mod N (value
    <= kN + 1), where the entry constant F defaults to 1 (residues of
    M_A^2 mod N enter the Montgomery domain) and the exit constant E to 1.
    The table is seeded with xd itself, so this is bit-equal to the kernel:
    the same integer representatives at every step.
    """
    entry = sys_.r2_dom if entry_res is None else entry_res
    xd = rns_mont_mul(x_res, entry.expand(x_res.shape), sys_)
    one = sys_.one_dom.expand(xd.shape)
    table = [one, xd]
    for _ in range(2**window - 2):
        table.append(rns_mont_mul(table[-1], xd, sys_))
    acc = one
    for digit in np.asarray(torch.as_tensor(digits).cpu()).tolist():
        for _ in range(window):
            acc = rns_mont_mul(acc, acc, sys_)
        acc = rns_mont_mul(acc, table[digit], sys_)
    unit = sys_.scale if exit_res is None else exit_res
    return rns_mont_mul(acc, unit.expand(acc.shape), sys_)


def ladder_vec_plain(x_res, digits, sys_, window=DEFAULT_WINDOW,
                     exit_res=None, entry_res=None):
    """Plain PyTorch version of the per-element ladder kernel.

    x_res: [B, cpad] stored residues of values < 2kN; digits: [B, n_windows]
    MSB-first base-2^window digits, one schedule per element (a host array
    or tensor, any integer type). Returns [B, cpad] residues of
    (x F)^e_i E mod N: ladder_plain with each element's own exponent. The
    table factor is exactly tab[d] (phe_tpu's one-hot sum picks the same
    integers), so this is bit-equal to the kernel and to phe_tpu's
    pow_vec_xla.
    """
    entry = sys_.r2_dom if entry_res is None else entry_res
    xd = rns_mont_mul(x_res, entry.expand(x_res.shape), sys_)
    one = sys_.one_dom.expand(xd.shape)
    table = [one, xd]
    for _ in range(2**window - 2):
        table.append(rns_mont_mul(table[-1], xd, sys_))
    table = torch.stack(table)  # [2^w, B, cpad]
    digits = torch.as_tensor(digits).to(device=x_res.device,
                                         dtype=torch.int64)
    rows = torch.arange(x_res.shape[0], device=x_res.device)
    acc = one
    for wi in range(digits.shape[-1]):
        for _ in range(window):
            acc = rns_mont_mul(acc, acc, sys_)
        acc = rns_mont_mul(acc, table[digits[:, wi], rows], sys_)
    unit = sys_.scale if exit_res is None else exit_res
    return rns_mont_mul(acc, unit.expand(acc.shape), sys_)


def pow_vec(x_limbs, digits, conv, sys_, window=DEFAULT_WINDOW,
            exit_res=None, entry_res=None):
    """Per-element x_i^e_i mod N (up to +jN, j <= k) via the RNS ladder.

    x_limbs: [B, Lin] binary limbs, value < 2kN; digits: [B, n_windows]
    schedules. Returns [B, out_limbs] canonical limbs of value <= kN + 1.
    The ladder runs in the CUDA kernel for tensors on the card and in
    ladder_vec_plain for tensors on the CPU (cuda_rns.ladder_vec).
    """
    from phe_tpu_torch.ops import cuda_rns

    x = to_rns(x_limbs, conv, sys_).contiguous()
    out = cuda_rns.ladder_vec(x, digits, sys_, window=window,
                              exit_res=exit_res, entry_res=entry_res)
    return from_rns(out, sys_)


def pow_shared(x_limbs, digits, conv, sys_, window=DEFAULT_WINDOW,
               exit_res=None, entry_res=None):
    """x^e mod N (up to +jN, j <= k) via the RNS ladder.

    x_limbs: [B, Lin] binary limbs, value < 2kN. Returns [B, out_limbs]
    canonical limbs of value <= kN + 1. The ladder itself runs in the CUDA
    kernel for tensors on the card and in ladder_plain for tensors on the
    CPU (phe_tpu_torch.ops.cuda_rns.ladder). exit_res / entry_res: see
    ladder_plain.
    """
    from phe_tpu_torch.ops import cuda_rns

    x = to_rns(x_limbs, conv, sys_).contiguous()
    out = cuda_rns.ladder(x, digits, sys_, window=window, exit_res=exit_res,
                          entry_res=entry_res)
    return from_rns(out, sys_)
