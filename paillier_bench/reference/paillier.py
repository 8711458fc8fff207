"""Plain Paillier with python-paillier's base-16 encoding: the yardstick.

Python integers and NumPy only. Nothing here imports jax, phe_tpu or
phe_tpu_torch, or takes anything the program under test made: the keys
come from the configuration's primes, the values from the benchmark's
generator, and the program's outputs (ciphertext integers, decrypted
floats) are only read to be judged.

* ``Key``: n, n^2 and the CRT constants from p and q; ``decrypt`` is
  Paillier decryption with CRT (python-paillier phe/paillier.py:346-353),
  ``blinded`` tells a ciphertext that carries an n-th power r^n with
  r != 1 mod n from the unblinded 1 + n m, which anyone can read.
* ``encode`` is python-paillier's EncodedNumber.encode at precision None,
  word for word (phe/encoding.py: the exponent from the float's least
  significant bit, the mantissa by exact rational rounding);
  ``encode_array`` is the same map on NumPy arrays, exact because BASE is
  a power of two (the tests hold it equal to ``encode``); ``decode`` is
  EncodedNumber.decode.
* ``aligned_sum``: the exact encoded sum of several encoded numbers, as
  python-paillier's EncryptedNumber addition forms it (each operand
  brought down to the smallest exponent by BASE ** diff, phe/paillier.py:
  664-669), as a signed integer mantissa and the exponent;
  ``aligned_sums`` is the same over the columns of an array.
"""

import fractions
import math

import numpy as np

BASE = 16
LOG2_BASE = 4
FLOAT_MANTISSA_BITS = 53


class Key:
    """A Paillier key pair from its primes (g = n + 1)."""

    def __init__(self, p, q):
        self.p, self.q = p, q
        self.n = p * q
        self.nsquare = self.n * self.n
        self.max_int = self.n // 3 - 1
        self.psquare, self.qsquare = p * p, q * q
        self.hp = self._h(p, self.psquare)
        self.hq = self._h(q, self.qsquare)
        self.p_inverse = pow(p, -1, q)

    def _h(self, d, dsquare):
        g = self.n + 1
        return pow((pow(g, d - 1, dsquare) - 1) // d, -1, d)

    def decrypt(self, c):
        """The plaintext residue in [0, n) of ciphertext c."""
        if not 0 < c < self.nsquare:
            raise ValueError("ciphertext out of range")
        mp = (pow(c, self.p - 1, self.psquare) - 1) // self.p * self.hp % self.p
        mq = (pow(c, self.q - 1, self.qsquare) - 1) // self.q * self.hq % self.q
        return mp + (mq - mp) * self.p_inverse % self.q * self.p

    def blinded(self, c):
        """Whether c carries an obfuscator: c = (1 + n m) r^n mod n^2 has
        c = r^n mod n, which is 1 only for r = 1 mod n (no blinding)."""
        return c % self.n != 1

    def residue(self, mantissa):
        """A signed mantissa as the plaintext residue mod n."""
        if abs(mantissa) > self.max_int:
            raise OverflowError("mantissa outside the +/- max_int window")
        return mantissa % self.n

    def signed(self, residue):
        """A plaintext residue as the signed mantissa it encodes."""
        if residue <= self.max_int:
            return residue
        if residue >= self.n - self.max_int:
            return residue - self.n
        raise OverflowError("residue in the overflow window")


def encode(x):
    """(signed mantissa, exponent) of a float, as python-paillier's
    EncodedNumber.encode(public_key, x) at precision None."""
    bin_lsb_exponent = math.frexp(x)[1] - FLOAT_MANTISSA_BITS
    exponent = math.floor(bin_lsb_exponent / LOG2_BASE)
    mantissa = round(fractions.Fraction(x)
                     * fractions.Fraction(BASE) ** -exponent)
    return mantissa, exponent


def encode_array(a):
    """encode over a float64 array: (int64 mantissas, int64 exponents).

    The least significant bit of a finite double lies at 2^(e2 - 53), and
    the exponent puts 16^-exponent at least that far up, so x scaled by
    it is an integer below 2^57 and the scaling by a power of two is
    exact: no rounding happens.
    """
    a = np.asarray(a, dtype=np.float64)
    if not np.isfinite(a).all():
        raise ValueError("only finite floats encode")
    _, e2 = np.frexp(a)
    exps = np.floor_divide(e2.astype(np.int64) - FLOAT_MANTISSA_BITS,
                           LOG2_BASE)
    mant = np.ldexp(a, (-LOG2_BASE * exps).astype(np.int32))
    return mant.astype(np.int64), exps


def decode(mantissa, exponent):
    """EncodedNumber.decode: exact for exponent >= 0, else one correctly
    rounded division of integers."""
    if exponent >= 0:
        return mantissa * BASE ** exponent
    return mantissa / BASE ** -exponent


def aligned_sum(mantissas, exponents):
    """The exact encoded sum: (signed mantissa, exponent) with the
    exponent the least of the operands'."""
    target = min(int(e) for e in exponents)
    total = 0
    for m, e in zip(mantissas, exponents):
        total += int(m) << (LOG2_BASE * (int(e) - target))
    return total, target


def aligned_sums(mantissas, exponents):
    """aligned_sum of each column of [operands, columns] int64 arrays:
    the exact sums as Python integers, at the columns' least exponents."""
    shifts = LOG2_BASE * (exponents - exponents.min(axis=0))
    return (mantissas.astype(object) << shifts.astype(object)).sum(
        axis=0).tolist()
