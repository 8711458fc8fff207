"""Host-side packing between Python integers and fixed-width limb arrays.

The device engine (phe_tpu_torch.ops) represents big integers as arrays of
base ``2**LIMB_BITS`` limbs, least-significant limb first, shape
``[..., num_limbs]``. This module is the host boundary: it converts CPython
ints (the reference library's native representation, phe/paillier.py) to and
from that packed format as numpy ``uint32`` arrays (the device side carries
them as int64 tensors). Conversion is vectorised through numpy bit
unpacking so that batches of thousands of 4096-bit integers pack in
milliseconds; nothing here runs in the device hot path.

The limb radix is 2**14: the device engine keeps limbs in a redundant
carry-save form where a limb may temporarily hold values up to 2**14
inclusive, a sub-16-bit radix guarantees every partial product and
accumulator in the Montgomery pipeline stays below 2**31, and 14 bits =
two exact 7-bit digits for the int8 digit matmuls (see
phe_tpu_torch/ops/limb_math.py for the bound analysis).
"""

import numpy as np

LIMB_BITS = 14
LIMB_MASK = (1 << LIMB_BITS) - 1

__all__ = [
    "LIMB_BITS",
    "LIMB_MASK",
    "num_limbs_for_bits",
    "bytes_to_limbs",
    "int_to_limbs",
    "limbs_to_int",
    "ints_to_limbs",
    "limbs_to_ints",
]


def num_limbs_for_bits(nbits, limb_bits=LIMB_BITS):
    """Number of limbs needed to hold an nbits-bit integer."""
    return -(-nbits // limb_bits)


def int_to_limbs(value, num_limbs, limb_bits=LIMB_BITS):
    """Pack one non-negative int into a [num_limbs] uint32 array (LSB first)."""
    return ints_to_limbs([value], num_limbs, limb_bits)[0]


def limbs_to_int(limbs, limb_bits=LIMB_BITS):
    """Exact value of a (possibly redundant / non-normalised) limb array."""
    return limbs_to_ints(np.asarray(limbs)[None, :], limb_bits)[0]


def bytes_to_limbs(buf, num_limbs, limb_bits=LIMB_BITS):
    """[B, nbytes] little-endian uint8 rows -> [B, num_limbs] uint32 limbs.

    Vectorised bit slicing: limb j covers bits [limb_bits*j,
    limb_bits*(j+1)), spanning at most three bytes for limb_bits <= 16 —
    three static gathers, a shift and a mask, no per-element Python.
    Bits beyond num_limbs * limb_bits are ignored.
    """
    buf = np.asarray(buf, dtype=np.uint8)
    need = (limb_bits * num_limbs + 7) // 8 + 2
    if buf.shape[1] < need:
        buf = np.pad(buf, ((0, 0), (0, need - buf.shape[1])))
    j = np.arange(num_limbs)
    o = (limb_bits * j) // 8
    s = ((limb_bits * j) % 8).astype(np.uint32)
    word = (
        buf[:, o].astype(np.uint32)
        | (buf[:, o + 1].astype(np.uint32) << 8)
        | (buf[:, o + 2].astype(np.uint32) << 16)
    )
    return (word >> s) & np.uint32((1 << limb_bits) - 1)


def ints_to_limbs(values, num_limbs, limb_bits=LIMB_BITS):
    """Pack a sequence of non-negative ints into a [B, num_limbs] uint32 array.

    Bits beyond num_limbs * limb_bits must be zero (raises if a value does
    not fit). One C-speed to_bytes per value feeds the vectorised
    byte-slicer; nothing here is per-limb Python.
    """
    total_bits = num_limbs * limb_bits
    nbytes = (total_bits + 7) // 8
    buf = np.zeros((len(values), nbytes + 2), dtype=np.uint8)
    for i, v in enumerate(values):
        if v < 0:
            raise ValueError("limb packing requires non-negative integers")
        if v.bit_length() > total_bits:
            raise ValueError(
                "value of %d bits does not fit in %d limbs of %d bits"
                % (v.bit_length(), num_limbs, limb_bits)
            )
        buf[i, :nbytes] = np.frombuffer(
            v.to_bytes(nbytes, "little"), dtype=np.uint8
        )
    return bytes_to_limbs(buf, num_limbs, limb_bits)


def ints_to_bytes(values, nbytes):
    """Pack non-negative ints into a [B, nbytes] little-endian uint8 array.

    The minimal host->device wire format (1 byte per 8 bits, vs 4-byte
    uint32 lanes per 14-bit limb); the device unpacks with
    limb_math.unpack_bytes. One C-speed to_bytes per value.
    """
    buf = np.zeros((len(values), nbytes), dtype=np.uint8)
    for i, v in enumerate(values):
        if v < 0:
            raise ValueError("byte packing requires non-negative integers")
        buf[i] = np.frombuffer(v.to_bytes(nbytes, "little"), dtype=np.uint8)
    return buf


def limbs_to_ints(limbs, limb_bits=LIMB_BITS):
    """Exact values of a [B, L] limb array (redundant limbs allowed).

    Limbs may exceed the radix (carry-save form): the result is the exact
    integer sum(limb[i] << (limb_bits * i)).
    """
    limbs = np.asarray(limbs)
    if limbs.ndim != 2:
        raise ValueError("expected a [B, L] array, got shape %r" % (limbs.shape,))
    out = []
    shifts = [limb_bits * i for i in range(limbs.shape[1])]
    for row in limbs:
        acc = 0
        # Horner from the most significant limb: one shift+add per limb,
        # exact for redundant (over-radix) limbs too.
        for limb in row[::-1].tolist():
            acc = (acc << limb_bits) + limb
        out.append(acc)
    return out
