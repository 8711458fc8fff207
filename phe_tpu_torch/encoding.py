"""Fixed-point encoding: signed ints/floats <-> residues of the plaintext ring.

Paillier operates on residues in [0, n); users hand us signed floats. The
bridge is mantissa * BASE**exponent with the mantissa stored mod n, and the
ring split into three windows by ``max_int = n//3 - 1``:

    [0, max_int]                    positive mantissas
    (max_int, n - max_int)          dead zone -> OverflowError on decode
    [n - max_int, n)                negative mantissas (wrapped mod n)

Keeping a third of the ring as a dead zone is what makes *detectable*
overflow possible: the sum of two in-range values can land there, but can
never silently cross into the wrong sign window (an undetectable wrap needs
magnitudes ~3x max_int).

Every numeric decision is bit-pinned to the reference (phe/encoding.py,
vendored alt-base suites): exponent selection from the float's least
significant mantissa bit (or an explicit precision) floored in base-BASE,
mantissa rounding as exact round-half-even rational arithmetic, and the
int/int division on decode (the reference's exact-decode fix). All of
it is exact host integer math — the device engine only ever sees finished
residues, packed into limb tensors by phe_tpu_torch.batch.
"""

import fractions
import math
import sys


class EncodedNumber(object):
    """One signed number as (residue mod n, base-BASE exponent).

    BASE is a class attribute (default 16) so wire-compatible alternative
    radices are a subclass away (examples/alternative_base.py); LOG2_BASE
    must stay consistent with it.

    Attributes:
      public_key: supplies n and max_int (the window geometry).
      encoding (int): the mantissa as a residue in [0, n).
      exponent (int): the power of BASE scaling the mantissa.
    """

    BASE = 16
    LOG2_BASE = math.log(BASE, 2)
    FLOAT_MANTISSA_BITS = sys.float_info.mant_dig

    def __init__(self, public_key, encoding, exponent):
        self.public_key = public_key
        self.encoding = encoding
        self.exponent = exponent

    @classmethod
    def _natural_exponent(cls, scalar, precision):
        """The finest exponent worth keeping for ``scalar``.

        Without an explicit precision: 0 for ints (they are exact), and
        for floats the base-BASE floor of the exponent of the least
        significant IEEE-754 mantissa bit — any finer digit would encode
        noise the float never held. With a precision: the largest exponent
        whose unit step is no coarser than it.
        """
        if precision is not None:
            return math.floor(math.log(precision, cls.BASE))
        if isinstance(scalar, int):
            return 0
        if isinstance(scalar, float):
            lsb = math.frexp(scalar)[1] - cls.FLOAT_MANTISSA_BITS
            return math.floor(lsb / cls.LOG2_BASE)
        raise TypeError(
            "cannot infer an encoding precision for %s" % type(scalar)
        )

    @classmethod
    def encode(cls, public_key, scalar, precision=None, max_exponent=None):
        """Encode one int or float exactly.

        The mantissa is round(Fraction(scalar) * BASE**-exponent): exact
        rational scaling with round-half-even, which is what keeps odd
        bases (BASE=13 in the vendored suites) bit-identical to the
        reference. Magnitudes beyond max_int don't fit the signed windows
        and raise ValueError.
        """
        exponent = cls._natural_exponent(scalar, precision)
        if max_exponent is not None:
            exponent = min(max_exponent, exponent)

        mantissa = round(
            fractions.Fraction(scalar)
            * fractions.Fraction(cls.BASE) ** -exponent
        )
        if abs(mantissa) > public_key.max_int:
            raise ValueError(
                "encoded mantissa %d exceeds the +/-%d window"
                % (mantissa, public_key.max_int)
            )
        return cls(public_key, mantissa % public_key.n, exponent)

    @classmethod
    def encode_many(cls, public_key, values):
        """Exact encoding of a whole sequence (the batch-encrypt prologue).

        Bit-identical to per-element ``encode``, but when BASE is a power
        of two the rational path collapses: scalar * BASE**-exponent is a
        power-of-two scaling, exact in IEEE-754 via ``math.ldexp``, and
        Python's round() is the same round-half-even. Other bases and
        non-floats take the rational path element-wise.
        """
        log2b = cls.BASE.bit_length() - 1
        fast = cls.BASE == (1 << log2b)
        n, max_int = public_key.n, public_key.max_int
        out = []
        for scalar in values:
            if isinstance(scalar, EncodedNumber):
                out.append(scalar)
            elif fast and isinstance(scalar, float):
                lsb = math.frexp(scalar)[1] - cls.FLOAT_MANTISSA_BITS
                exponent = math.floor(lsb / cls.LOG2_BASE)
                mantissa = round(math.ldexp(scalar, -log2b * exponent))
                if abs(mantissa) > max_int:
                    raise ValueError(
                        "encoded mantissa %d exceeds the +/-%d window"
                        % (mantissa, max_int)
                    )
                out.append(cls(public_key, mantissa % n, exponent))
            else:
                out.append(cls.encode(public_key, scalar))
        return out

    def _signed_mantissa(self):
        """Map the residue back through the window split to a signed int."""
        n, max_int = self.public_key.n, self.public_key.max_int
        if self.encoding >= n:
            raise ValueError("residue >= n: ciphertext or encoding corrupt")
        if self.encoding <= max_int:
            return self.encoding
        if self.encoding >= n - max_int:
            return self.encoding - n
        raise OverflowError("encoded value fell in the overflow window")

    def decode(self):
        """Back to an int (exponent >= 0, exact) or float.

        Negative exponents divide int by int so precision survives until
        the single final conversion to float, as the reference decodes.
        """
        mantissa = self._signed_mantissa()
        if self.exponent >= 0:
            return mantissa * self.BASE**self.exponent
        try:
            return mantissa / self.BASE**-self.exponent
        except OverflowError as e:
            raise OverflowError("decoded result too large for a float") from e

    def decrease_exponent_to(self, new_exp):
        """The same value at a finer exponent: mantissa *= BASE**diff mod n."""
        if new_exp > self.exponent:
            raise ValueError(
                "%i is not lower than the current exponent %i"
                % (new_exp, self.exponent)
            )
        shifted = (
            self.encoding * pow(self.BASE, self.exponent - new_exp)
        ) % self.public_key.n
        return self.__class__(self.public_key, shifted, new_exp)
