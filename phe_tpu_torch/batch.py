"""Batch-first Paillier: ciphertext batches as Montgomery limb tensors.

The PyTorch counterpart of phe_tpu/batch.py. A batch of B ciphertexts
lives on one device as ``int64[Bp, L]`` limbs in the Montgomery domain mod
n^2 (Bp: B rounded up to a power-of-two bucket, padded with identity rows),
and:

* fresh encryption is nude = n*m + 1 (the g = n+1 shortcut,
  phe/paillier.py:132-134) times the obfuscator r^n, with r^n on the
  modexp engine and the limb products in the Montgomery kernel; the short mode
  takes h^a for one cached h = x^n and a fresh 320-bit a per element, on
  the limb-engine modexp kernels;
* decryption is CRT with exponents p-1, q-1 over p^2, q^2
  (phe/paillier.py:346-353) on two modexps, then the Hensel L-function,
  the hp/hq products and the CRT recombination on the device, and a compact
  decode that ships 3 words per element to the host;
* homomorphic add is one Montgomery product mod n^2 (phe/paillier.py:
  705-719); scalar multiply, exponent alignment, sums at mixed exponents
  and matvec run one per-element-exponent modexp (_pow_elems,
  phe/paillier.py:721-751), negative scalars on the batch-inverted
  ciphertexts; sums are log-depth Montgomery-product trees.

Two modexp engines, as in phe_tpu on its chip, with no knob between them:
the RNS ladder (csrc/rns_ladder.cu) wherever the channel-prime supply
covers the modulus (rns.fits: moduli up to ~8,760 bits), and the limb
engine's windowed modexps (csrc/mont_pow.cu) past it. The choice is made
per modulus: ``rns_state()`` is None past the supply, and each program
with an RNS twin (_encrypt_limb, _obfuscate_limb, _pow_elems,
_decrypt_residue_limb) runs on that answer alone. Keys up to ~4,380 bits
run everything on RNS; at 8192-bit keys n^2 (16,384 bits) runs on the limb
engine while the decrypt halves p^2, q^2 (8,192 bits) stay on RNS; only
above ~8,760-bit keys does decryption take the limb engine too. Encoding
exponents are host-side numpy metadata. Blinding factors r come from the
host CSPRNG (``secrets``), never from a torch generator.
"""

import functools
import secrets
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from phe_tpu_torch.encoding import EncodedNumber
from phe_tpu_torch.ops import limb_math as lm
from phe_tpu_torch.ops import montgomery as mg
from phe_tpu_torch.ops import rns
from phe_tpu_torch.utils import limbs as hl
from phe_tpu_torch.utils.ntheory import invert

# Window of the per-element modexps (scalar multiply, alignment, short
# obfuscation), of the CRT decrypt ladders (1024-bit exponents at 2048-bit
# keys: 1262 products per half) and of the encrypt / obfuscate ladder
# (2048-bit exponent n: 2492 products).
DEFAULT_WINDOW = mg.DEFAULT_WINDOW
DECRYPT_WINDOW = 5
ENCRYPT_WINDOW = 5
_MIN_BUCKET = 4
_WINDOW_GROUP = 8
# Exponent bits of short obfuscation's h^a.
SHORT_EXPONENT_BITS = 320
# rns_state()'s cache before its first call (None is a cached answer).
_UNBUILT = object()


def bucket_rows(b):
    """Smallest power-of-two row count >= b (min 4)."""
    return max(_MIN_BUCKET, 1 << (b - 1).bit_length()) if b > 1 else _MIN_BUCKET


def _bucket_bits(bits, window=DEFAULT_WINDOW):
    """Round a digit-schedule width up to whole groups of 8 windows."""
    group = window * _WINDOW_GROUP
    return -(-bits // group) * group


def _digits_rows(exponents, bits, window=DEFAULT_WINDOW, pad_rows=None,
                 pad_value=1):
    """Stack per-element MSB-first digit schedules into [Bp, n_windows].

    Width-bucketed; rows pad to pad_rows with the schedule of pad_value
    (default 1: x^1 = x, a safe identity for padded lanes). The schedules
    are int8 when every digit fits (window <= 6), the wire form the
    kernels take. Exponents below 2^64 take numpy's shifts; wider ones go
    through their little-endian bytes and bit planes (phe_tpu computes
    those per element; the digits are the same).
    """
    bits = _bucket_bits(max(bits, 1), window)
    n_windows = -(-bits // window)
    out_dtype = np.int8 if window <= 6 else np.int32

    def windows_of(arr):
        shifts = np.arange(n_windows - 1, -1, -1, dtype=np.uint64) * np.uint64(
            window)
        mask = np.uint64((1 << window) - 1)
        return ((arr[:, None] >> shifts[None, :]) & mask).astype(out_dtype)

    narrow = (n_windows - 1) * window < 64
    if (isinstance(exponents, np.ndarray) and exponents.dtype == np.int64
            and narrow):
        # Prepared non-negative int64 arrays (_signed_mantissas_fast).
        arr = exponents.astype(np.uint64)
        if pad_rows is not None and len(arr) < pad_rows:
            arr = np.concatenate(
                [arr, np.full(pad_rows - len(arr), pad_value, np.uint64)])
        return windows_of(arr)
    exponents = [int(e) for e in exponents]
    if pad_rows is not None and len(exponents) < pad_rows:
        exponents += [pad_value] * (pad_rows - len(exponents))
    if narrow and all(0 <= e < (1 << 64) for e in exponents):
        return windows_of(np.array(exponents, dtype=np.uint64))
    if any(e < 0 or e.bit_length() > n_windows * window for e in exponents):
        raise ValueError("exponents must lie in [0, 2^%d)"
                         % (n_windows * window))
    buf = hl.ints_to_bytes(exponents, -(-n_windows * window // 8))
    planes = np.unpackbits(buf, axis=1, bitorder="little")
    planes = planes[:, : n_windows * window].reshape(-1, n_windows, window)
    lsb_first = planes.astype(np.int64) @ (1 << np.arange(window))
    return lsb_first[:, ::-1].astype(out_dtype)


def _pad_list(values, target, fill):
    values = list(values)
    return values + [fill] * (target - len(values))


def _signed_mantissas_fast(public_key, scalars):
    """Vectorised (|mantissa| int64[B], neg uint8[B], exponent int64[B]).

    The no-bigint prologue of the scalar multiply: for finite floats under
    BASE=16 the encoding is exact in IEEE-754 (the exponent from frexp,
    the mantissa from one power-of-two ldexp, np.rint the same
    round-half-even as round()), so |mantissa| and the sign come out
    without the n-sized residue of the negative window. Homogeneous
    int64-range int lists reduce to abs and sign. Returns None whenever an
    element needs the exact rational path (mixed or other types,
    non-finite values, a mantissa past max_int at small keys): callers then
    take EncodedNumber.encode_many, which raises the reference's errors.

    The window check compares integers. phe_tpu compares against
    float(max_int), which rounds for max_int in (2^53, 2^57) and then
    passes a mantissa one above max_int (ROADMAP Queue 3).
    """
    if EncodedNumber.BASE != 16 or len(scalars) == 0:
        return None
    max_int = public_key.max_int
    if all(type(s) is float for s in scalars):
        a = np.asarray(scalars, dtype=np.float64)
        if not np.isfinite(a).all():
            return None
        _, e2 = np.frexp(a)
        exps = np.floor_divide(e2.astype(np.int64) - 53, 4)
        mant = np.rint(np.ldexp(a, -4 * exps))  # |mant| < 2^57: exact
        k = np.abs(mant).astype(np.int64)
        if max_int < (1 << 57) and (k > max_int).any():
            return None
        return k, (mant < 0).astype(np.uint8), exps
    if all(type(s) in (int, bool) for s in scalars):
        try:
            a = np.asarray(scalars, dtype=np.int64)
        except OverflowError:
            return None
        if a.min() == np.iinfo(np.int64).min:  # |min| overflows abs()
            return None
        k = np.abs(a)
        if max_int < (1 << 63) and (k > max_int).any():
            return None
        return k, (a < 0).astype(np.uint8), np.zeros(len(a), np.int64)
    return None


def _as_list(value, length):
    if np.isscalar(value):
        return [value] * length
    value = list(value)
    if len(value) != length:
        raise ValueError("scalar operand length mismatch")
    return value


def _bytes_to_ints(rows):
    """[B, nbytes] uint8 (tensor or array) -> Python ints, one per row."""
    rows = rows.cpu().numpy() if torch.is_tensor(rows) else np.asarray(rows)
    return [
        int.from_bytes(rows[i].tobytes(), "little")
        for i in range(rows.shape[0])
    ]


def _fit_limbs(wide, L):
    """Pad or truncate the trailing limb axis to exactly L limbs.

    Truncation is exact for RNS ladder outputs (value <= kN + 1, far
    below 2^(14 L - 16) by the context's headroom).
    """
    W = wide.shape[-1]
    if W < L:
        return F.pad(wide, (0, L - W))
    return wide[..., :L].contiguous()


def _export(mont, ctx):
    """Montgomery -> canonical residues, packed to bytes on the device."""
    return lm.pack_bytes(mg.export_canonical(mg.from_mont(mont, ctx), ctx))


class RnsPubState(NamedTuple):
    """RNS engine handle for one public modulus.

    entry_mont: stored residues of M_A^2 * R^-1 mod N — the entry constant
      of the per-element ladder, which divides the limb engine's
      Montgomery factor R out of a ciphertext operand.
    exit_r: stored residues of R mod N — the exit constant that lands
      ladder outputs directly in the limb Montgomery domain.
    red: mg.ExcessReducer absorbing the ladder's +jN offset (j <= k).
    """

    rsys: rns.RNSSystem
    conv: rns.RNSConversion
    entry_mont: torch.Tensor
    exit_r: torch.Tensor
    red: mg.ExcessReducer


def _rns_pow_to_mont(base_limbs, digits, st, ctx, window):
    """RNS-ladder modexp landing canonical in the Montgomery domain.

    base_limbs: [B, Lin] plain values (< 2kN). The ladder exits through
    R mod N, so the output is base^e * R (Montgomery form) <= kN + 1;
    reduce_excess absorbs the +jN offset.
    """
    wide = rns.pow_shared(base_limbs, digits, st.conv, st.rsys,
                          window=window, exit_res=st.exit_r)
    return _fit_limbs(mg.reduce_excess(wide, st.red), ctx.num_limbs)


def _pow_elems(mont, digits, ctx, rstate):
    """Per-element-exponent modexp, Montgomery domain in and out.

    The dispatch point of every data-dependent exponent (scalar multiply,
    exponent alignment, matvec grids: the reference's _raw_mul and
    decrease_exponent_to, phe/paillier.py:721-751, :570-601). mont:
    [..., L]; digits: [..., n_windows] schedules at DEFAULT_WINDOW (host
    int8 arrays, as _digits_rows makes them). rstate None (a modulus past
    the RNS channel supply) runs the limb engine's per-row modexp
    (mg.mont_pow), output < 1.01 M. An RnsPubState runs the RNS ladder,
    entering through M_A^2 R^-1, which strips the operand's R
    ((c R) R^-1 = c), and exiting through R, which puts it back: no limb
    REDC on the path. reduce_excess absorbs the ladder's +jN offset, so
    its outputs are canonical < N. (phe_tpu's _pow_elems_dev is its jit
    wrapper.)
    """
    if rstate is None:
        return mg.mont_pow(mont, digits, ctx)
    lead = mont.shape[:-1]
    L = ctx.num_limbs
    digits = np.asarray(digits)
    wide = rns.pow_vec(mont.reshape(-1, L),
                       digits.reshape(-1, digits.shape[-1]),
                       rstate.conv, rstate.rsys,
                       entry_res=rstate.entry_mont, exit_res=rstate.exit_r)
    out = _fit_limbs(mg.reduce_excess(wide, rstate.red), L)
    return out.reshape(lead + (L,))


def _nude_raw(m, nr2, ctx):
    """(n*m + 1) in Montgomery form for encoded residues m < n.

    One shared-operand Montgomery product by nr2 = n*R^2 mod n^2
    (m*nr2*R^-1 = n*m*R), then a limbwise add of R mod n^2.
    """
    m_pad = F.pad(m, (0, ctx.num_limbs - m.shape[-1]))
    prod = mg.mont_mul_const(m_pad, nr2, ctx)  # n*m*R mod n^2, < 1.01 M
    return lm.add(prod, ctx.one.expand(prod.shape))  # < 2.01 M


def _encrypt_rns(m_bytes, r_bytes, nr2, n_digits, ctx, st, ln):
    """Fresh encryption (n*m + 1) * r^n mod n^2, Montgomery form."""
    m = lm.unpack_bytes(m_bytes, ln)
    r = lm.unpack_bytes(r_bytes, ctx.num_limbs)
    nude = _nude_raw(m, nr2, ctx)
    obf = _rns_pow_to_mont(r, n_digits, st, ctx, ENCRYPT_WINDOW)
    return mg.mont_mul(nude, obf, ctx)


def _obfuscate_rns(mont, r_bytes, n_digits, ctx, st):
    """Re-obfuscation ct * r^n mod n^2 (phe/paillier.py:603-624)."""
    r = lm.unpack_bytes(r_bytes, ctx.num_limbs)
    obf = _rns_pow_to_mont(r, n_digits, st, ctx, ENCRYPT_WINDOW)
    return mg.mont_mul(mont, obf, ctx)


def _limb_obfuscator(r_bytes, n_digits, ctx):
    """r^n R mod n^2 on the limb engine: r enters the Montgomery domain
    (one shared-operand product), then the shared-exponent modexp."""
    r = lm.unpack_bytes(r_bytes, ctx.num_limbs)
    return mg.mont_pow_shared(mg.to_mont(r, ctx), n_digits, ctx,
                              window=ENCRYPT_WINDOW)


def _encrypt_limb(m_bytes, r_bytes, nr2, n_digits, ctx, ln):
    """_encrypt_rns on the limb engine, for n^2 past the RNS channel
    supply (phe_tpu's _encrypt_dev)."""
    nude = _nude_raw(lm.unpack_bytes(m_bytes, ln), nr2, ctx)
    return mg.mont_mul(nude, _limb_obfuscator(r_bytes, n_digits, ctx), ctx)


def _obfuscate_limb(mont, r_bytes, n_digits, ctx):
    """_obfuscate_rns on the limb engine (phe_tpu's _obfuscate_dev)."""
    return mg.mont_mul(mont, _limb_obfuscator(r_bytes, n_digits, ctx), ctx)


def _nude_encrypt_dev(m_bytes, nr2, ctx, ln):
    """(n*m + 1) in Montgomery form from packed message bytes."""
    return _nude_raw(lm.unpack_bytes(m_bytes, ln), nr2, ctx)


def _add_encoded_dev(mont, m_bytes, nr2, ctx, ln):
    """Scalar add: ct * (n*m + 1) mod n^2 (phe/paillier.py:673-675)."""
    return mg.mont_mul(mont, _nude_encrypt_dev(m_bytes, nr2, ctx, ln), ctx)


def _tree_fold(mont, ctx):
    """Montgomery-product tree over the leading axis, one launch per level.

    mont: [C, ..., L]; returns [1, ..., L]. An odd row carries to the next
    level. (phe_tpu's _tree_reduce_dev is its jit wrapper.)
    """
    L = ctx.num_limbs
    while mont.shape[0] > 1:
        size = mont.shape[0]
        half = size // 2
        a, b = mont[:half], mont[half : 2 * half]
        merged = mg.mont_mul(a.reshape(-1, L), b.reshape(-1, L),
                             ctx).reshape(a.shape)
        if size % 2:
            merged = torch.cat([merged, mont[2 * half :]], dim=0)
        mont = merged
    return mont


def _matvec_dev(mont, inv_mont, neg_mask, digits, ctx, rstate):
    """Encrypted matvec: base select, one grid pow, tree over D.

    mont / inv_mont: [D, L] encrypted weights and their inverses
    (Montgomery domain); neg_mask: [B, D] selecting the inverse base (the
    reference's inverse trick, phe/paillier.py:745-749, over the whole
    grid); digits: [B, D, W] schedules of |mantissa| * BASE**align_diff —
    the alignment is fused into the exponent, (c^x)^(BASE^d) = c^(x BASE^d).
    """
    B = digits.shape[0]
    mask = torch.as_tensor(np.asarray(neg_mask) != 0, device=mont.device)
    grid = (B,) + tuple(mont.shape)
    base = torch.where(mask[..., None], inv_mont.expand(grid),
                       mont.expand(grid))
    powed = _pow_elems(base, digits, ctx, rstate)  # [B, D, L]
    return _tree_fold(powed.transpose(0, 1), ctx)[0]


def _add_encrypted_aligned_dev(a_mont, da, b_mont, db, ctx, rstate):
    """E(a)+E(b) with per-element exponent alignment on both sides
    (phe/paillier.py:664-669's decrease_exponent_to), then the product."""
    a2 = _pow_elems(a_mont, da, ctx, rstate)
    b2 = _pow_elems(b_mont, db, ctx, rstate)
    return mg.mont_mul(a2, b2, ctx)


def _add_scalars_aligned_dev(a_mont, da, m_bytes, nr2, ctx, rstate, ln):
    """E(a)+b: the alignment pow, then the product with the nude (r = 1)."""
    a2 = _pow_elems(a_mont, da, ctx, rstate)
    return mg.mont_mul(a2, _nude_encrypt_dev(m_bytes, nr2, ctx, ln), ctx)


def _sum_aligned_dev(mont, digits, ctx, rstate):
    """Homomorphic sum at mixed exponents: alignment pow, then the tree."""
    return _tree_fold(_pow_elems(mont, digits, ctx, rstate), ctx)


def _inverse_scan_dev(mont, ctx):
    """Batch-inversion prefix products over a ciphertext batch.

    Returns (excl, total): excl[i] = prod_{j != i} c_j and total =
    prod_j c_j (Montgomery domain), so that one host inversion of total
    gives every c_i^-1 = excl[i] total^-1 (_finish_inverse_dev):
    Montgomery's batch-inversion identity. The forward and the reversed
    inclusive scans run together as a log-depth (Hillis-Steele) scan, one
    Montgomery-product launch per level: at level d, x[i] *= x[i - d].
    """
    B, L = mont.shape
    x = torch.stack([mont, mont.flip(0)])  # [2, B, L]
    d = 1
    while d < B:
        prod = mg.mont_mul(x[:, d:].reshape(-1, L), x[:, : B - d].reshape(-1, L),
                           ctx).reshape(2, B - d, L)
        x = torch.cat([x[:, :d], prod], dim=1)
        d *= 2
    incl, rev_incl = x[0], x[1].flip(0)
    one = ctx.one.expand(1, L)
    fwd_excl = torch.cat([one, incl[:-1]])
    rev_excl = torch.cat([rev_incl[1:], one])
    return mg.mont_mul(fwd_excl, rev_excl, ctx), incl[-1]


def _finish_inverse_dev(excl, tinv_mont, ctx):
    """excl[i] * total^-1 = c_i^-1, Montgomery domain."""
    return mg.mont_mul_const(excl, tinv_mont, ctx)


def _pow_select_dev(mont, inv_mont, neg_mask, digits, ctx, rstate):
    """Select the base c or c^-1 per element, then one per-element modexp.

    The batched negative-scalar branch of the inverse trick
    (phe/paillier.py:745-749): (c^-1)^|k| = (c^|k|)^-1, with the base
    selected before the pow, so a negative costs one short modexp like
    every other element.
    """
    mask = torch.as_tensor(np.asarray(neg_mask) != 0, device=mont.device)
    base = torch.where(mask[:, None], inv_mont, mont)
    return _pow_elems(base, digits, ctx, rstate)


def _short_base_dev(x_mont, n_digits, ctx):
    """h = x^n (Montgomery form) for short obfuscation: [1, L] in and out."""
    return mg.mont_pow_shared(x_mont, n_digits, ctx, window=ENCRYPT_WINDOW)


def _obfuscate_short_dev(mont, h_mont, digits, ctx):
    """ct * h^a_i mod n^2: one per-element modexp of the shared base h
    (digits [Bp, n_windows], the schedules of the a_i), then the product."""
    base = h_mont.expand(mont.shape).contiguous()
    return mg.mont_mul(mont, mg.mont_pow(base, digits, ctx), ctx)


def _lfunction_half(xc, ctxh, cm_pinv, h_limbs):
    """L(x, p) * h mod p for one CRT leg, from canonical x = c^(p-1) mod p^2.

    The L function is an exact Hensel division: (x-1)/p = (x-1) * p^-1
    mod 2^(14*Lh), exact because the quotient is < p < 2^(14*Lh).
    """
    t = xc[..., : ctxh.num_limbs]
    tm1 = lm.add(t, torch.full_like(t, lm.LIMB_MASK))  # t - 1 mod R_h
    # const_mul is exact only mod R_h; normalize pins the redundant
    # truncation to exactly (x-1)/p < R_h.
    lfun = lm.normalize(mg.const_mul(tm1, cm_pinv))
    hm = mg.mont_mul(
        mg.to_mont(lfun, ctxh), h_limbs.expand(lfun.shape).contiguous(), ctxh
    )  # = L * h mod p (plain domain: one to_mont, one REDC)
    return mg.export_canonical(hm, ctxh)


def _gt_const(x, comp):
    """Per-row indicator value(x) > T, for canonical x and comp = R-1-T."""
    s = F.pad(x, (0, 1)) + F.pad(comp.expand(x.shape), (0, 1))
    return lm.normalize(s)[..., -1]


def _decode_compact(m, pk):
    """Device half of float/int decoding: sign window + 64-bit mantissa.

    m: [B, W] plaintext residue limbs (< n). Emits int64 [B, 3] rows
    (mant_lo32, mant_hi32, flags): flags bit 0 = decodable (inside a sign
    window), bit 1 = negative window, bit 2 = |mantissa| < 2^64. The host
    finishes decoding and falls back to the exact bigint decode for rows
    with any flag unset.
    """
    m = lm.normalize(m)
    rc = torch.full_like(m, lm.LIMB_MASK) - m
    rc[..., 0] += 1  # R - m (redundant limbs <= 2^14)
    # n - m: the R excess carries out of the top limb, which normalize drops.
    nm = lm.normalize(pk.n_w.expand(m.shape) + rc)
    pos = _gt_const(m, pk.maxc_w) == 0  # m <= max_int
    negf = _gt_const(nm, pk.maxc_w) == 0  # n - m <= max_int
    ok = pos | negf
    mant = torch.where(negf[..., None], nm, m)
    w0 = mant[..., 0] | (mant[..., 1] << 14) | ((mant[..., 2] & 0xF) << 28)
    w1 = (
        (mant[..., 2] >> 4)
        | (mant[..., 3] << 10)
        | ((mant[..., 4] & 0xFF) << 24)
    )
    fits = (mant[..., 4] < 256) & (mant[..., 5:] == 0).all(dim=-1)
    flags = ok.long() | (negf.long() << 1) | (fits.long() << 2)
    return torch.stack([w0, w1, flags], dim=-1)


def _crt_recombine(mp, mq, pk):
    """mp + p*((q + mq - mp) p^-1 mod q) -> canonical plaintext limbs."""
    neg_mp = torch.full_like(mp, lm.LIMB_MASK) - mp
    neg_mp[..., 0] += 1  # R_h - mp (mp canonical)
    # q + mq + (R_h - mp) lies in [R_h, R_h + 2q): full normalisation drops
    # exactly one R_h out of the top limb.
    diff = lm.normalize(pk.q_limbs.expand(mq.shape) + mq + neg_mp)
    u = mg.export_canonical(
        mg.mont_mul(
            mg.to_mont(diff, pk.ctx_hq),
            pk.pinvq_limbs.expand(diff.shape).contiguous(),
            pk.ctx_hq,
        ),
        pk.ctx_hq,
    )
    # m = mp + p * u (< p*q = n): p is a per-key constant, so the full
    # product is one digit matmul (out = 2*Lh covers p*u exactly).
    prod = mg.const_mul(u, pk.cm_pfull)
    m = lm.add(prod, F.pad(mp, (0, prod.shape[-1] - mp.shape[-1])))
    return lm.normalize(m)


def _mont_entry(x, ctx2):
    """x * R mod p^2 for mod_reduce's [B, L2+1] output (value < 1.51 R).

    The top limb t has weight R and t <= 1, so x*R^2*R^-1 = REDC(x_lo *
    R^2) + t * R^2: one shared-operand product plus a limbwise add. The
    result has L2 limbs in [0, 2^14] and value < 3.01 p^2, inside both
    modexps' input bounds (the RNS ladder's 2kN; the limb modexp's first
    products land below 1.01 p^2 because R >= 2^16 p^2).
    """
    L2 = ctx2.num_limbs
    return lm.add(mg.mont_mul_const(x[..., :L2].contiguous(), ctx2.r2, ctx2),
                  x[..., L2:] * ctx2.r2)


def _decrypt_residue_limb(ct_mont, pub_ctx, pk):
    """_decrypt_residue_rns on the limb engine, for prime squares past the
    RNS channel supply (keys above ~8,760 bits; phe_tpu's
    _decrypt_residue_limb): per half, c^(p-1) mod p^2 by the
    shared-exponent limb modexp, out of the Montgomery domain to canonical
    limbs, then the same L-function and CRT recombination.
    """
    plain = mg.from_mont(ct_mont, pub_ctx)
    halves = []
    for ctx2, red, ddig, ctxh, cm_pinv, h_limbs in (
        (pk.ctx_p, pk.red_p, pk.dp_digits, pk.ctx_hp, pk.cm_pinv_p,
         pk.hp_limbs),
        (pk.ctx_q, pk.red_q, pk.dq_digits, pk.ctx_hq, pk.cm_pinv_q,
         pk.hq_limbs),
    ):
        xm = _mont_entry(mg.mod_reduce(plain, ctx2, red), ctx2)
        powed = mg.mont_pow_shared(xm, ddig, ctx2, window=DECRYPT_WINDOW)
        xc = mg.export_canonical(mg.from_mont(powed, ctx2), ctx2)
        halves.append(_lfunction_half(xc, ctxh, cm_pinv, h_limbs))
    return _crt_recombine(halves[0], halves[1], pk)


def _decrypt_residue_rns(ct_mont, pub_ctx, pk, half_p, half_q):
    """CRT decryption with both half-width modexps on the RNS ladder.

    The wide ciphertext residue folds into each prime-square range
    (mod_reduce) and enters the limb Montgomery domain before conversion to
    residues; the extra R factor leaves through the ladder's exit constant
    E = R^(1-p): (xR)^(p-1) * R^(1-p) = x^(p-1), the plain value the
    L-function needs. half_*: (RNSSystem, RNSConversion, exit_res,
    ExcessReducer) per prime square.
    """
    plain = mg.from_mont(ct_mont, pub_ctx)
    halves = []
    for ctx2, red, ddig, (rsys, conv, ers, red2), ctxh, cm_pinv, h_limbs in (
        (pk.ctx_p, pk.red_p, pk.dp_digits, half_p, pk.ctx_hp,
         pk.cm_pinv_p, pk.hp_limbs),
        (pk.ctx_q, pk.red_q, pk.dq_digits, half_q, pk.ctx_hq,
         pk.cm_pinv_q, pk.hq_limbs),
    ):
        L2 = ctx2.num_limbs
        xm = _mont_entry(mg.mod_reduce(plain, ctx2, red), ctx2)
        wide = rns.pow_shared(
            xm, ddig, conv, rsys, window=DECRYPT_WINDOW, exit_res=ers
        )
        # The ladder output is the plain x^(p-1) + j p^2; reduce_excess
        # lands it canonical < p^2.
        xc = _fit_limbs(mg.reduce_excess(wide, red2), L2)
        halves.append(_lfunction_half(xc, ctxh, cm_pinv, h_limbs))
    return _crt_recombine(halves[0], halves[1], pk)


class PublicDeviceContext:
    """Per-public-key constants on one device, and the encrypt programs."""

    def __init__(self, public_key, device):
        self.public_key = public_key
        self.device = device
        n = public_key.n
        self.n = n
        self.n_bits = n.bit_length()
        self.ctx = mg.build_context(public_key.nsquare, device)
        self.L = self.ctx.num_limbs  # limbs of the mod-n^2 engine
        self.Ln = hl.num_limbs_for_bits(self.n_bits)  # packing width, m < n
        # Digit schedule of the public exponent n (obfuscator r^n).
        self.n_digits = torch.as_tensor(
            mg.exponent_digits(n, self.n_bits, ENCRYPT_WINDOW), device=device
        )
        # n * R^2 mod n^2: the shared operand of the (n*m + 1) prologue.
        R = 1 << (lm.LIMB_BITS * self.L)
        nsq = public_key.nsquare
        self.nr2_limbs = mg._tensor(
            hl.int_to_limbs(n * (R * R % nsq) % nsq, self.L), device
        )
        self._rns = _UNBUILT
        # h = x^n of short obfuscation, [1, L] Montgomery form (first use).
        self._h_mont = None

    def rns_state(self):
        """RnsPubState for modexp mod n^2 (built on first use), or None.

        None when n^2 exceeds the RNS channel prime supply (keys above
        ~4,380 bits): the modexps mod n^2 then run on the limb engine,
        which has no size ceiling. Either answer is cached.
        """
        if self._rns is _UNBUILT:
            nsq = self.public_key.nsquare
            self._rns = self._build_rns(nsq) if rns.fits(nsq) else None
        return self._rns

    def _build_rns(self, nsq):
        rsys = rns.build_rns(nsq, self.device)
        R = 1 << (lm.LIMB_BITS * self.L)
        M_A = 1
        for a in rsys.m[: rsys.k].tolist():
            M_A *= a
        return RnsPubState(
            rsys=rsys,
            conv=rns.build_conversion(rsys, self.L),
            entry_mont=rns.residues(
                M_A * M_A % nsq * pow(R, -1, nsq) % nsq, rsys),
            exit_r=rns.residues(R % nsq, rsys),
            red=mg.build_excess_reducer(nsq, rsys.out_limbs, self.device),
        )

    def rstate(self):
        """The engine handle of the per-element programs (_pow_elems):
        the RnsPubState, or None for the limb engine."""
        return self.rns_state()

    # -- packing ---------------------------------------------------------

    def pack_mod_nsquare(self, values):
        """Canonical residues mod n^2 -> Montgomery-domain [Bp, L]."""
        values = _pad_list(values, bucket_rows(len(values)), 1)
        x = mg._tensor(hl.ints_to_limbs(values, self.L), self.device)
        return mg.to_mont(x, self.ctx)

    def export_ints(self, mont):
        """Montgomery-domain [B, L] -> canonical Python ints in [0, n^2)."""
        return _bytes_to_ints(_export(mont, self.ctx))

    def pack_messages(self, encodings, pad_rows=None):
        """Encoded residues m < n -> [Bp, nb] uint8 rows on the device.

        Rows pad with m = 0 (nude ciphertext 1) up to pad_rows or the
        bucket size. Bytes, not limbs: the device unpacks them.
        """
        if pad_rows is None:
            pad_rows = bucket_rows(len(encodings))
        encodings = _pad_list(encodings, pad_rows, 0)
        buf = hl.ints_to_bytes(encodings, (self.n_bits + 7) // 8)
        return torch.as_tensor(buf, device=self.device)

    def nude_encrypt(self, encodings):
        """(n*m + 1) mod n^2 in Montgomery form, for residues m < n.

        The g = n+1 shortcut (phe/paillier.py:132-134) holds for every
        residue in [0, n), the negative window included, so the batch path
        needs no data-dependent branch.
        """
        return _nude_encrypt_dev(self.pack_messages(encodings),
                                 self.nr2_limbs, self.ctx, self.Ln)

    def random_r_bytes(self, count, r_values=None):
        """[Bp, nb] uint8 blinding bases from the system CSPRNG.

        With r_values given, reproduces the reference bit-for-bit, padding
        to the row bucket with r = 1 (identity obfuscator). The default
        draw is one token_bytes call of (n_bits + 64)-bit raw values: r^n
        with r the raw value is within 2^-64 statistical distance of the
        reference's uniform r in [1, n).
        """
        bucket = bucket_rows(count)
        nbytes = (self.n_bits + 64 + 7) // 8
        if r_values is not None:
            r_values = _pad_list(r_values, bucket, 1)
            need = max(
                nbytes, max((v.bit_length() + 7) // 8 for v in r_values)
            )
            buf = hl.ints_to_bytes(r_values, need)
        else:
            buf = np.frombuffer(
                bytearray(secrets.token_bytes(bucket * nbytes)), dtype=np.uint8
            ).reshape(bucket, nbytes)
        return torch.as_tensor(buf, device=self.device)

    def encrypt_mont(self, encodings, r_values=None):
        """Fresh encryption (n*m+1)*r^n for encoded residues -> [Bp, L]."""
        m = self.pack_messages(encodings)
        r = self.random_r_bytes(len(encodings), r_values)
        st = self.rns_state()
        if st is None:
            return _encrypt_limb(m, r, self.nr2_limbs, self.n_digits,
                                 self.ctx, self.Ln)
        return _encrypt_rns(m, r, self.nr2_limbs, self.n_digits, self.ctx,
                            st, self.Ln)

    def obfuscate_mont(self, mont):
        """Fresh uniform re-obfuscation of a Montgomery ciphertext batch."""
        r = self.random_r_bytes(mont.shape[0])
        st = self.rns_state()
        if st is None:
            return _obfuscate_limb(mont, r, self.n_digits, self.ctx)
        return _obfuscate_rns(mont, r, self.n_digits, self.ctx, st)

    def obfuscate_mont_short(self, mont, exponent_bits=SHORT_EXPONENT_BITS):
        """Re-obfuscation by h^a, with h = x^n fixed per key and device and
        a fresh exponent_bits-bit a per element.

        Damgard-Jurik-style shortened randomness: under the decisional
        composite residuosity assumption the obfuscators are
        indistinguishable from uniform n-th powers, at about
        n_bits / exponent_bits of the modexp cost. A documented departure
        from the reference's uniform r (phe_tpu's knob, kept as it is);
        the default encrypt path stays exact. x and the a come from the
        host CSPRNG (``secrets``).
        """
        if self._h_mont is None:
            x = 1 + secrets.randbelow(self.n - 1)
            xm = mg.to_mont(mg._tensor(hl.ints_to_limbs([x], self.L),
                                       self.device), self.ctx)
            self._h_mont = _short_base_dev(xm, self.n_digits, self.ctx)
        a = [secrets.randbits(exponent_bits) for _ in range(mont.shape[0])]
        return _obfuscate_short_dev(mont, self._h_mont,
                                    _digits_rows(a, exponent_bits), self.ctx)

    def mul_mont(self, a, b):
        return mg.mont_mul(a, b, self.ctx)

    def pow_scalars(self, ct_mont, exponents, exponent_bits):
        """ct^e_i with per-element exponents (scalar multiply).

        Pads the exponent list to the (bucketed) row count of ct_mont with
        e = 1, under which padded rows stay encryptions of 0.
        """
        digits = _digits_rows(exponents, exponent_bits,
                              pad_rows=ct_mont.shape[0])
        return _pow_elems(ct_mont, digits, self.ctx, self.rstate())


class PrivateDeviceConstants(NamedTuple):
    """Per-private-key constants on one device for the decrypt program."""

    ctx_p: mg.MontgomeryContext  # mod p^2
    red_p: mg.ReduceTable
    dp_digits: torch.Tensor  # p-1 digit schedule
    ctx_q: mg.MontgomeryContext  # mod q^2
    red_q: mg.ReduceTable
    dq_digits: torch.Tensor
    ctx_hp: mg.MontgomeryContext  # mod p (half width)
    ctx_hq: mg.MontgomeryContext  # mod q
    cm_pinv_p: mg.ConstMulTable  # * (p^-1 mod 2^(14*Lh))
    cm_pinv_q: mg.ConstMulTable  # * (q^-1 mod 2^(14*Lh))
    cm_pfull: mg.ConstMulTable  # * p, exact full product (CRT recombine)
    hp_limbs: torch.Tensor  # hp canonical [Lh]
    hq_limbs: torch.Tensor
    pinvq_limbs: torch.Tensor  # p^-1 mod q canonical [Lh]
    q_limbs: torch.Tensor  # q canonical [Lh]
    n_w: torch.Tensor  # n canonical [2 Lh] (decode window tests)
    maxc_w: torch.Tensor  # 2^(28 Lh) - 1 - max_int canonical [2 Lh]


class PrivateDeviceContext:
    """Per-private-key constants on one device for batched CRT decryption."""

    def __init__(self, private_key, device):
        self.private_key = private_key
        self.device = device
        pub = private_key.public_key
        self.pub_ctx = pub.device_context(device)
        p, q = private_key.p, private_key.q
        ctx_p = mg.build_context(private_key.psquare, device)
        ctx_q = mg.build_context(private_key.qsquare, device)
        wide = self.pub_ctx.L
        half_bits = max(p.bit_length(), q.bit_length())
        ctx_hp = mg.build_context(p, device)
        ctx_hq = mg.build_context(q, device, num_limbs=ctx_hp.num_limbs)
        Lh = max(ctx_hp.num_limbs, ctx_hq.num_limbs)
        if ctx_hp.num_limbs != Lh:
            ctx_hp = mg.build_context(p, device, num_limbs=Lh)
        Rh = 1 << (lm.LIMB_BITS * Lh)
        pack = lambda v: mg._tensor(hl.int_to_limbs(v, Lh), device)
        digits = lambda e: torch.as_tensor(
            mg.exponent_digits(e, half_bits, DECRYPT_WINDOW), device=device
        )
        self.consts = PrivateDeviceConstants(
            ctx_p=ctx_p,
            red_p=mg.build_reduce_table(private_key.psquare, ctx_p, wide,
                                        device),
            dp_digits=digits(p - 1),
            ctx_q=ctx_q,
            red_q=mg.build_reduce_table(private_key.qsquare, ctx_q, wide,
                                        device),
            dq_digits=digits(q - 1),
            ctx_hp=ctx_hp,
            ctx_hq=ctx_hq,
            cm_pinv_p=mg.build_const_mul(pow(p, -1, Rh), Lh, Lh, device),
            cm_pinv_q=mg.build_const_mul(pow(q, -1, Rh), Lh, Lh, device),
            cm_pfull=mg.build_const_mul(p, Lh, 2 * Lh, device),
            hp_limbs=pack(private_key.hp),
            hq_limbs=pack(private_key.hq),
            pinvq_limbs=pack(private_key.p_inverse),
            q_limbs=pack(q),
            n_w=mg._tensor(hl.int_to_limbs(pub.n, 2 * Lh), device),
            maxc_w=mg._tensor(hl.int_to_limbs(
                (1 << (lm.LIMB_BITS * 2 * Lh)) - 1 - pub.max_int, 2 * Lh
            ), device),
        )
        self._rns = _UNBUILT

    def rns_state(self):
        """Per-prime-square RNS halves for the CRT decrypt modexps, or None.

        Each half is (RNSSystem, RNSConversion, exit_res, ExcessReducer):
        the ladder enters with Montgomery-domain values x*R < 3.01 p^2 and
        exits through E = R^(1-p) mod p^2, landing at the plain x^(p-1).
        None when either prime square exceeds the RNS channel supply (keys
        above ~8,760 bits): decryption then runs on the limb engine
        (_decrypt_residue_limb). Either answer is cached.
        """
        if self._rns is _UNBUILT:
            priv = self.private_key
            squares = ((priv.p, priv.psquare, self.consts.ctx_p),
                       (priv.q, priv.qsquare, self.consts.ctx_q))
            self._rns = None
            if all(rns.fits(nsq) for _, nsq, _ in squares):
                self._rns = tuple(self._build_half(pp, nsq, ctx2)
                                  for pp, nsq, ctx2 in squares)
        return self._rns

    def _build_half(self, pp, nsq, ctx2):
        rsys = rns.build_rns(nsq, self.device)
        R = 1 << (lm.LIMB_BITS * ctx2.num_limbs)
        E = pow(pow(R, -1, nsq), pp - 1, nsq)
        return (rsys, rns.build_conversion(rsys, ctx2.num_limbs),
                rns.residues(E, rsys),
                mg.build_excess_reducer(nsq, rsys.out_limbs, self.device))

    def _residue(self, ct_mont):
        halves = self.rns_state()
        if halves is None:
            return _decrypt_residue_limb(ct_mont, self.pub_ctx.ctx,
                                         self.consts)
        return _decrypt_residue_rns(ct_mont, self.pub_ctx.ctx, self.consts,
                                    *halves)

    def raw_decrypt_launch(self, ct_mont):
        """Run the decrypt program: [Bp, nbytes] packed plaintext bytes."""
        return lm.pack_bytes(self._residue(ct_mont))

    def raw_decrypt_batch(self, ct_mont):
        """Exact plaintext residues mod n for a Montgomery ciphertext batch."""
        return _bytes_to_ints(self.raw_decrypt_launch(ct_mont))

    def raw_decrypt_compact(self, ct_mont):
        """(compact decode rows [Bp, 3], full packed bytes) — _decode_compact."""
        m = self._residue(ct_mont)
        return _decode_compact(m, self.consts), lm.pack_bytes(m)


class EncryptedBatch:
    """A batch of Paillier ciphertexts resident on one device.

    Attributes:
      public_key: the shared PaillierPublicKey.
      mont: int64[Bp, L] ciphertexts, Montgomery domain mod n^2 (Bp is the
        bucketed row count; the logical length is len(exponents)).
      exponents: int64 numpy [B], per-element encoding exponents.
      is_obfuscated: whether every element carries fresh r^n blinding
        (the lazy-obfuscation state machine, phe/paillier.py:531-568).
    """

    def __init__(self, public_key, mont, exponents, is_obfuscated=False):
        self.public_key = public_key
        self.mont = mont
        self.exponents = np.asarray(exponents, dtype=np.int64)
        self.is_obfuscated = is_obfuscated
        # The ciphertexts' modular inverses (Montgomery domain), for the
        # negative-scalar inverse trick; computed at first use and reset
        # whenever self.mont is replaced (obfuscation on secure export).
        self._inv_mont = None

    def __len__(self):
        """Logical batch length (the mont tensor rows are bucket-padded)."""
        return len(self.exponents)

    @property
    def mont_logical(self):
        """Montgomery limb rows of the logical batch (padding trimmed)."""
        return self.mont[: len(self)]

    @property
    def _dc(self):
        return self.public_key.device_context(self.mont.device)

    @classmethod
    def encrypt(cls, public_key, values, precision=None, r_values=None,
                obfuscation="exact", device=None):
        """Encode and encrypt a sequence of ints/floats on ``device``.

        obfuscation: "exact" draws uniform r < n from the host CSPRNG and
        computes r^n (the reference's distribution, phe/paillier.py:
        136-143); "short" multiplies by h^a (obfuscate_mont_short); "none"
        leaves the ciphertexts unblinded (r = 1), not marked obfuscated,
        for intermediate values. With r_values pinned, the ciphertexts are
        reproducible and not marked obfuscated, whatever the mode.
        device: None for CUDA, "cpu" for the plain PyTorch versions.
        """
        dc = public_key.device_context(device)
        if precision is None:
            encodings = EncodedNumber.encode_many(public_key, values)
        else:
            encodings = [
                v if isinstance(v, EncodedNumber)
                else EncodedNumber.encode(public_key, v, precision)
                for v in values
            ]
        exponents = [e.exponent for e in encodings]
        residues = [e.encoding for e in encodings]
        if r_values is not None:
            mont = dc.encrypt_mont(residues, r_values)
            return cls(public_key, mont, exponents, is_obfuscated=False)
        if obfuscation == "exact":
            mont = dc.encrypt_mont(residues)
        elif obfuscation == "short":
            mont = dc.obfuscate_mont_short(dc.nude_encrypt(residues))
        elif obfuscation == "none":
            return cls(public_key, dc.nude_encrypt(residues), exponents,
                       is_obfuscated=False)
        else:
            raise ValueError("unknown obfuscation mode: %r" % (obfuscation,))
        return cls(public_key, mont, exponents, is_obfuscated=True)

    @classmethod
    def from_ciphertext_ints(cls, public_key, ciphertexts, exponents,
                             is_obfuscated=False, device=None):
        """Import raw int ciphertexts (deserialisation boundary)."""
        dc = public_key.device_context(device)
        mont = dc.pack_mod_nsquare(list(ciphertexts))
        return cls(public_key, mont, exponents, is_obfuscated)

    @classmethod
    def from_encrypted_numbers(cls, numbers, be_secure=False, device=None):
        """Lift scalar EncryptedNumber objects onto ``device``."""
        if not numbers:
            raise ValueError("empty batch")
        pub = numbers[0].public_key
        cts = [e.ciphertext(be_secure=be_secure) for e in numbers]
        exps = [e.exponent for e in numbers]
        return cls.from_ciphertext_ints(pub, cts, exps,
                                        is_obfuscated=be_secure,
                                        device=device)

    def ciphertext_ints(self, be_secure=True):
        """Raw int ciphertexts, obfuscating first when be_secure.

        Obfuscation persists on this batch (the reference's
        on-first-secure-read state machine): repeated secure exports return
        the same ciphertexts without re-paying the r^n modexp.
        """
        if be_secure and not self.is_obfuscated:
            self.mont = self.obfuscate().mont
            self._inv_mont = None
            self.is_obfuscated = True
        return self._dc.export_ints(self.mont)[: len(self)]

    def to_encrypted_numbers(self, be_secure=True):
        from phe_tpu_torch.encrypted import EncryptedNumber

        cts = self.ciphertext_ints(be_secure=be_secure)
        return [
            EncryptedNumber(self.public_key, c, int(e))
            for c, e in zip(cts, self.exponents)
        ]

    def decrypt(self, private_key, Encoding=None):
        """Decrypt and decode the whole batch.

        With the stock base-16 EncodedNumber the decode finishes on the
        compact device rows (_decode_compact); custom Encoding classes take
        the exact bigint path.
        """
        return self.decrypt_async(private_key, Encoding)()

    def decrypt_async(self, private_key, Encoding=None):
        """Run the device half of decryption now; return a finisher.

        The returned zero-argument callable copies the result to the host
        and completes the decode. ``decrypt`` is ``decrypt_async(...)()``.
        """
        if private_key.public_key != self.public_key:
            raise ValueError(
                "encrypted batch was encrypted against a different key!"
            )
        if Encoding is None:
            Encoding = EncodedNumber
        pdc = private_key.device_context(self.mont.device)
        if Encoding is EncodedNumber and EncodedNumber.BASE == 16:
            compact, full = pdc.raw_decrypt_compact(self.mont)
            return functools.partial(
                self._finish_decrypt_fast, compact, full, Encoding
            )
        packed = pdc.raw_decrypt_launch(self.mont)

        def finish():
            residues = _bytes_to_ints(packed)
            return [
                Encoding(self.public_key, m, int(e)).decode()
                for m, e in zip(residues, self.exponents)
            ]

        return finish

    def _finish_decrypt_fast(self, compact, full, Encoding):
        """Vectorised decode from the compact device rows.

        BASE=16 is a power of two, so decoding is mantissa * 2^(4 e). For
        e < 0, converting the < 2^64 mantissa to float64 rounds half-even
        once and np.ldexp is then exact for normal results — the same single
        rounding as the reference's exact division. The doubly-rounded
        corner (mantissa > 2^53 and a subnormal result), overflow-window
        rows and mantissas >= 2^64 take the exact bigint decode.
        """
        B = len(self)
        c = compact[:B].cpu().numpy()
        flags = c[:, 2]
        mant = c[:, 0].astype(np.uint64) | (c[:, 1].astype(np.uint64) << 32)
        exps = self.exponents
        ok = (flags & 1) != 0
        neg = (flags & 2) != 0
        fits = (flags & 4) != 0
        easy = ok & fits & (
            (mant <= np.uint64(1 << 53)) | (4 * exps + 64 >= -960)
        )
        out = [None] * B
        fl = easy & (exps < 0)
        if fl.any():
            idx = np.nonzero(fl)[0]
            signed = np.where(neg[idx], -1.0, 1.0) * mant[idx].astype(
                np.float64
            )
            vals = np.ldexp(signed, (4 * exps[idx]).astype(np.int32))
            for i, v in zip(idx, vals):
                out[i] = float(v)
        for i in np.nonzero(easy & (exps >= 0))[0]:
            v = int(mant[i]) * 16 ** int(exps[i])
            out[i] = -v if neg[i] else v
        hard = ~easy
        if hard.any():
            ints = _bytes_to_ints(full[:B])
            for i in np.nonzero(hard)[0]:
                out[i] = Encoding(
                    self.public_key, ints[i], int(exps[i])
                ).decode()
        return out

    # -- homomorphic algebra ------------------------------------------------

    def obfuscate(self, mode="exact"):
        """Multiply every element by a fresh obfuscator: r^n
        (phe/paillier.py:603-624) or, with mode "short", h^a."""
        dc = self._dc
        if mode == "exact":
            mont = dc.obfuscate_mont(self.mont)
        elif mode == "short":
            mont = dc.obfuscate_mont_short(self.mont)
        else:
            raise ValueError("unknown obfuscation mode: %r" % (mode,))
        return EncryptedBatch(self.public_key, mont, self.exponents, True)

    def decrease_exponent_to(self, new_exps):
        """Per-element exponent alignment: multiply by BASE**diff.

        new_exps: a scalar or [B] target exponents, each <= the element's
        own. The hidden modexp of the reference's decrease_exponent_to
        (phe/paillier.py:570-601) becomes one per-element-exponent ladder
        over the batch.
        """
        new_exps = np.broadcast_to(
            np.asarray(new_exps, dtype=np.int64), self.exponents.shape
        )
        diffs = self.exponents - new_exps
        if (diffs < 0).any():
            raise ValueError("New exponent should be more negative")
        if not diffs.any():
            return self
        factors = [EncodedNumber.BASE ** int(d) for d in diffs]
        bits = max(f.bit_length() for f in factors)
        mont = self._dc.pow_scalars(self.mont, factors, bits)
        return EncryptedBatch(self.public_key, mont, new_exps, False)

    def _aligned(self, other_exponents):
        """Align self and an exponent vector to the per-element minimum."""
        target = np.minimum(self.exponents, other_exponents)
        return self.decrease_exponent_to(target), target

    def _align_digits(self, target):
        """[Bp, W] BASE**diff digit schedules aligning self to target."""
        diffs = self.exponents - np.asarray(target, dtype=np.int64)
        factors = [EncodedNumber.BASE ** int(d) for d in diffs]
        bits = max(f.bit_length() for f in factors)
        return _digits_rows(factors, bits, pad_rows=self.mont.shape[0])

    def __add__(self, other):
        if isinstance(other, EncryptedBatch):
            return self._add_encrypted(other)
        return self.add_scalars(other)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        if isinstance(other, EncryptedBatch):
            return self + other.mul_scalars([-1] * len(other))
        return self + [-v for v in _as_list(other, len(self))]

    def __mul__(self, other):
        return self.mul_scalars(other)

    def __rmul__(self, other):
        return self.mul_scalars(other)

    def _add_encrypted(self, other):
        """Elementwise E(a)+E(b): alignment pows, then one product."""
        if self.public_key != other.public_key:
            raise ValueError(
                "Attempted to add numbers encrypted against "
                "different public keys!"
            )
        if len(self) != len(other):
            raise ValueError("batch size mismatch")
        target = np.minimum(self.exponents, other.exponents)
        dc = self._dc
        if (self.exponents == target).all() and (
            other.exponents == target
        ).all():
            mont = dc.mul_mont(self.mont, other.mont)
        else:
            mont = _add_encrypted_aligned_dev(
                self.mont, self._align_digits(target),
                other.mont, other._align_digits(target),
                dc.ctx, dc.rstate(),
            )
        return EncryptedBatch(self.public_key, mont, target, False)

    def add_scalars(self, scalars):
        """Elementwise E(a) + b for plaintext scalars.

        Encodes each scalar at max_exponent = the element's exponent
        (phe/paillier.py:640-641), aligns, and multiplies by the unblinded
        encryption of the scalar (r = 1, :673).
        """
        scalars = _as_list(scalars, len(self))
        encodings = [
            s if isinstance(s, EncodedNumber)
            else EncodedNumber.encode(self.public_key, s, max_exponent=int(e))
            for s, e in zip(scalars, self.exponents)
        ]
        b_exps = np.array([e.exponent for e in encodings], dtype=np.int64)
        target = np.minimum(self.exponents, b_exps)
        aligned = [
            e if e.exponent == t else e.decrease_exponent_to(int(t))
            for e, t in zip(encodings, target)
        ]
        dc = self._dc
        m = dc.pack_messages([e.encoding for e in aligned],
                             pad_rows=self.mont.shape[0])
        if (self.exponents == target).all():
            mont = _add_encoded_dev(self.mont, m, dc.nr2_limbs, dc.ctx, dc.Ln)
        else:
            mont = _add_scalars_aligned_dev(
                self.mont, self._align_digits(target), m, dc.nr2_limbs,
                dc.ctx, dc.rstate(), dc.Ln,
            )
        return EncryptedBatch(self.public_key, mont, target, False)

    # Rows per batch-inversion scan: the price of a chunk is one host
    # inversion (phe_tpu pins its scan to one compiled shape with it).
    _INVERSE_CHUNK = 8192

    def inverse_mont(self):
        """Montgomery-domain modular inverses c_i^-1 mod n^2, cached.

        Montgomery's batch-inversion identity: the log-depth product scans
        of _inverse_scan_dev on the device and one host inversion of the
        running product per chunk serve the whole batch (the reference pays
        one extended-Euclid inversion per negative scalar,
        phe/util.py:85-103).
        """
        if self._inv_mont is None:
            dc = self._dc
            nsq = self.public_key.nsquare
            chunks = []
            rows = self.mont.shape[0]
            step = self._INVERSE_CHUNK
            for lo in range(0, rows, step):
                excl, total = _inverse_scan_dev(self.mont[lo : lo + step],
                                                dc.ctx)
                total_int = dc.export_ints(total[None])[0]
                tinv = dc.pack_mod_nsquare([invert(total_int, nsq)])[0]
                chunks.append(_finish_inverse_dev(excl, tinv, dc.ctx))
            self._inv_mont = torch.cat(chunks) if len(chunks) > 1 else chunks[0]
        return self._inv_mont

    def _signed_exponents(self, encodings):
        """Split encoded residues into (|k| exponents, negative mask).

        The reference's inverse trick (phe/paillier.py:745-749): residues
        in the negative window use n - encoding (short, like every float or
        int mantissa) as the exponent on the inverted ciphertext.
        """
        pub = self.public_key
        neg_window = pub.n - pub.max_int
        ks, neg = [], []
        for e in encodings:
            if e.encoding >= neg_window:
                ks.append(pub.n - e.encoding)
                neg.append(1)
            else:
                ks.append(e.encoding)
                neg.append(0)
        return ks, neg

    def mul_scalars(self, scalars):
        """Elementwise E(a) * b: one short per-element modexp.

        Negative scalars select the batch-inverted (cached) ciphertext as
        the base: (c^-1)^|k| = (c^|k|)^-1 mod n^2, so every element pays one
        short modexp. For negative scalars the ciphertext differs from the
        reference's c^plaintext by an n-th-power factor, as the reference's
        own inverse branch does; decryption agrees exactly.
        """
        scalars = _as_list(scalars, len(self))
        pub = self.public_key
        fast = _signed_mantissas_fast(pub, scalars)
        if fast is not None:
            ks, neg, sc_exps = fast
            any_neg = bool(neg.any())
            bits = max(int(ks.max()).bit_length(), 1)
        else:
            encodings = EncodedNumber.encode_many(pub, scalars)
            ks, neg = self._signed_exponents(encodings)
            sc_exps = np.array([e.exponent for e in encodings],
                               dtype=np.int64)
            any_neg = any(neg)
            bits = max(max(k.bit_length() for k in ks), 1)
        dc = self._dc
        digits = _digits_rows(ks, bits, pad_rows=self.mont.shape[0])
        if any_neg:
            mask = np.pad(np.asarray(neg, dtype=np.uint8),
                          (0, self.mont.shape[0] - len(neg)))
            mont = _pow_select_dev(self.mont, self.inverse_mont(), mask,
                                   digits, dc.ctx, dc.rstate())
        else:
            mont = _pow_elems(self.mont, digits, dc.ctx, dc.rstate())
        return EncryptedBatch(self.public_key, mont,
                              self.exponents + sc_exps, False)

    def sum(self):
        """Homomorphic sum of the batch: a log-depth tree of Montgomery
        products mod n^2, the aggregation primitive of the FL example
        (examples/federated_learning_with_encryption.py:122-133)."""
        target = int(self.exponents.min())
        dc = self._dc
        if (self.exponents == target).all():
            mont = _tree_fold(self.mont, dc.ctx)
        else:
            mont = _sum_aligned_dev(
                self.mont,
                self._align_digits(np.full_like(self.exponents, target)),
                dc.ctx, dc.rstate(),
            )
        return EncryptedBatch(self.public_key, mont, np.array([target]),
                              False)

    def dot(self, plain_vector):
        """Encrypted dot product: mul_scalars, then the tree sum
        (examples/logistic_regression_encrypted_model.py:170-177)."""
        return self.mul_scalars(plain_vector).sum()

    def matvec(self, matrix):
        """scores = matrix @ self for a plaintext [B, D] matrix against D
        encrypted weights: one [B, D] grid of per-element modexps with the
        exponent alignment fused in, and a Montgomery-product tree over D,
        against the reference's B * D sequential powmods
        (examples/logistic_regression_encrypted_model.py:170-177). Returns
        an EncryptedBatch of B encrypted dot products.
        """
        matrix = np.asarray(matrix)
        if matrix.ndim != 2 or matrix.shape[1] != len(self):
            raise ValueError(
                "expected [B, %d] matrix, got %r" % (len(self), matrix.shape)
            )
        B, D = matrix.shape
        dc = self._dc
        w_mont = self.mont[:D]  # the grid is logical-D: trim the padding
        encodings = [
            EncodedNumber.encode_many(self.public_key, row)
            for row in matrix.tolist()
        ]
        # The signed split over the grid: negative entries cost short
        # exponents on the inverted weight, not n-sized residues.
        flat = [e for row in encodings for e in row]
        ks, neg = self._signed_exponents(flat)
        # Product exponents e_w[i] + e_x[j, i]; each row aligns to its
        # minimum inside the modexp: (c^+-|k|)^(BASE^d) = c^(+-|k| BASE^d).
        exp_grid = self.exponents[None, :D] + np.array(
            [[e.exponent for e in row] for row in encodings], dtype=np.int64
        )
        row_min = exp_grid.min(axis=1)
        diffs = (exp_grid - row_min[:, None]).reshape(-1)
        exps = [k * EncodedNumber.BASE ** int(d) for k, d in zip(ks, diffs)]
        bits = max(max(e.bit_length() for e in exps), 1)
        digits = _digits_rows(exps, bits).reshape(B, D, -1)
        inv_mont = self.inverse_mont()[:D] if any(neg) else w_mont
        mask = np.array(neg, dtype=np.uint8).reshape(B, D)
        mont = _matvec_dev(w_mont, inv_mont, mask, digits, dc.ctx,
                           dc.rstate())
        return EncryptedBatch(self.public_key, mont, row_min, False)
