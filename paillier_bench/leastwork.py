"""The least work of a step, from its sizes alone, and the card's peaks.

A step's cryptographic work is counted as the schoolbook operations its
inputs need, whatever kernel, engine or REDC body runs it, so that a
rewrite of a kernel moves the share of this bound and not the bound:

* one modular product at a W-bit modulus works on d = ceil(W / 8)
  eight-bit digits: the product a*b (d^2 digit products), the Montgomery
  quotient q = T_lo * M' mod R (the low half: d(d+1)/2) and q*M (d^2);
  a squaring's a*a needs only d(d+1)/2;
* a modexp with a b-bit exponent needs b - 1 squarings (the least any
  windowing reaches; its multiplications are not counted);
* a digit product is a multiply and an add: 2 integer operations.

The operations are turned into time at the published dense int8 peak of
one H100 SXM, 1,979 TOP/s, and the bytes at its 3.35 TB/s; the larger
of the two is the least time (NVIDIA H100 data sheet; both at the full
700 W power limit, which each run prints beside its numbers). An
algorithm below schoolbook (Karatsuba-like) would read above 100 % of
this bound: the count would then need changing, in a benchmark change of
its own.

Per protocol (the arguments are the sizes the inputs need):

* ``fl_step``: C clients encrypt D coordinates each (r^n mod n^2: an
  n_bits exponent, then the product (1 + n m) * r^n), the aggregator
  aligns each ciphertext to the coordinate's least exponent (a modexp by
  16^diff) and multiplies the C ciphertexts of each coordinate (C - 1
  products), and the key holder decrypts D sums (c^(p-1) mod p^2,
  c^(q-1) mod q^2 and three products at the half width: h_p, h_q and the
  recombination's p^-1).
"""

import numpy as np

INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12


def _digits(bits):
    return -(-int(bits) // 8)


def product_ops(bits):
    d = _digits(bits)
    return 2 * (2 * d * d + d * (d + 1) // 2)


def square_ops(bits):
    d = _digits(bits)
    return 2 * (d * d + d * (d + 1))


def modexp_ops(mod_bits, exp_bits):
    """exp_bits: one exponent's bit length, or an array of them."""
    squarings = np.maximum(np.asarray(exp_bits, dtype=np.int64) - 1, 0)
    return int(squarings.sum()) * square_ops(mod_bits)


def decrypt_ops(p_bits, q_bits):
    half = max(p_bits, q_bits)
    return (modexp_ops(2 * p_bits, p_bits) + modexp_ops(2 * q_bits, q_bits)
            + 3 * product_ops(half))


def least_seconds(ops, nbytes):
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def fl_step(n_bits, p_bits, q_bits, clients, coords, align_bits):
    """(operations, bytes) of one aggregation step. align_bits: the bit
    lengths of the alignment exponents 16^diff, one per client and
    coordinate (1 where the ciphertext is already at the least
    exponent)."""
    wide = 2 * n_bits
    ops = clients * coords * (modexp_ops(wide, n_bits) + product_ops(wide))
    ops += modexp_ops(wide, align_bits)
    ops += coords * (clients - 1) * product_ops(wide)
    ops += coords * decrypt_ops(p_bits, q_bits)
    # Each client ciphertext written once and read once; values in, sums out.
    nbytes = clients * coords * (2 * wide // 8 + 8) + coords * 8
    return ops, nbytes
