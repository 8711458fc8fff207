"""Scalar ciphertext algebra: one host integer per EncryptedNumber.

The homomorphisms are D(E(a) * E(b)) = a + b and D(E(a)^k) = a * k; this
module dresses them as ordinary ``+``/``-``/``*``/``/`` against plaintext
scalars and other ciphertexts, with the fixed-point exponent bookkeeping
that makes float arithmetic come out right (contract per
phe/paillier.py:442-752 and the vendored obfuscation-state tests).

Scope note: this is the drop-in scalar surface. It exists for parity,
interop and small hosts; anything measured in batches belongs in
phe_tpu_torch.batch.EncryptedBatch, which holds ciphertexts as Montgomery
limb tensors on the GPU.
"""

from phe_tpu_torch.encoding import EncodedNumber
from phe_tpu_torch.keys import PaillierPublicKey
from phe_tpu_torch.utils.ntheory import invert, mulmod, powmod


def _require_shared_key(mine, theirs):
    if mine != theirs:
        raise ValueError(
            "operands live under different public keys; homomorphic "
            "combination is only defined within one key"
        )


class EncryptedNumber(object):
    """A Paillier ciphertext int plus its fixed-point encoding exponent.

    Blinding is lazy (the expensive r^n factor is skipped on derived
    results) and tracked in ``__is_obfuscated``; reading the ciphertext
    for anything that leaves the trust boundary must go through
    ``ciphertext(be_secure=True)``, which blinds on first secure read.
    """

    def __init__(self, public_key, ciphertext, exponent=0):
        # Parity quirk: a nested EncryptedNumber is NOT rejected — the
        # reference's guard (phe/paillier.py:485) tests the bound method
        # `self.ciphertext`, never the value, so it accepts nesting too.
        if not isinstance(public_key, PaillierPublicKey):
            raise TypeError("public_key should be a PaillierPublicKey")
        self.public_key = public_key
        self.exponent = exponent
        self.__raw = ciphertext
        self.__is_obfuscated = False

    # -- ciphertext access and blinding ----------------------------------

    def ciphertext(self, be_secure=True):
        """The ciphertext integer; blinds first when be_secure.

        Derived results (sums, scalings) carry no fresh randomness —
        releasing them raw would let the recipient relate them to their
        inputs. The first be_secure read pays one r^n modexp and the
        state sticks, so later reads are free.
        """
        if be_secure and not self.__is_obfuscated:
            self.obfuscate()
        return self.__raw

    def obfuscate(self):
        """Multiply in a fresh r^n blinding factor (phe/paillier.py:603-624)."""
        pub = self.public_key
        r = pub.get_random_lt_n()
        self.__raw = mulmod(
            self.__raw, powmod(r, pub.n, pub.nsquare), pub.nsquare
        )
        self.__is_obfuscated = True

    # -- exponent management ----------------------------------------------

    def decrease_exponent_to(self, new_exp):
        """Re-express at a lower exponent: scale the mantissa by BASE^diff.

        The scaling rides the multiply homomorphism, so this is a hidden
        modexp — the cost alignment pays whenever two operands disagree.
        """
        if new_exp > self.exponent:
            raise ValueError(
                "%i is not lower than the current exponent %i"
                % (new_exp, self.exponent)
            )
        scaled = self * pow(EncodedNumber.BASE, self.exponent - new_exp)
        scaled.exponent = new_exp
        return scaled

    def _at_exponent(self, target):
        """Self, re-encoded at ``target`` if not already there."""
        return self if self.exponent == target else self.decrease_exponent_to(
            target
        )

    # -- addition ----------------------------------------------------------

    def __add__(self, other):
        if isinstance(other, EncryptedNumber):
            return self._plus_encrypted(other)
        if isinstance(other, EncodedNumber):
            return self._plus_encoded(other)
        # Plain scalar: encode no finer than our own exponent — extra
        # precision would be thrown away by alignment anyway
        # (phe/paillier.py:640-641).
        return self._plus_encoded(
            EncodedNumber.encode(
                self.public_key, other, max_exponent=self.exponent
            )
        )

    def __radd__(self, other):
        return self.__add__(other)

    def _plus_encrypted(self, other):
        """E(a) + E(b): align exponents, multiply ciphertexts mod n^2."""
        _require_shared_key(self.public_key, other.public_key)
        target = min(self.exponent, other.exponent)
        a = self._at_exponent(target)
        b = other._at_exponent(target)
        total = mulmod(
            a.ciphertext(False), b.ciphertext(False), self.public_key.nsquare
        )
        return EncryptedNumber(self.public_key, total, target)

    def _plus_encoded(self, encoded):
        """E(a) + plaintext b: absorb b's unblinded ciphertext.

        The plaintext side enters as g^b with no r^n factor — blinding an
        operand the caller already knows would be spent randomness
        (phe/paillier.py:645-676).
        """
        _require_shared_key(self.public_key, encoded.public_key)
        target = min(self.exponent, encoded.exponent)
        a = self._at_exponent(target)
        b = encoded if encoded.exponent == target else (
            encoded.decrease_exponent_to(target)
        )
        total = mulmod(
            a.ciphertext(False),
            self.public_key._nude_ciphertext(b.encoding),
            self.public_key.nsquare,
        )
        return EncryptedNumber(self.public_key, total, target)

    # -- scaling -----------------------------------------------------------

    def __mul__(self, other):
        if isinstance(other, EncryptedNumber):
            raise NotImplementedError(
                "the product of two Paillier ciphertexts is not "
                "computable; the scheme is additively homomorphic only"
            )
        encoding = (
            other
            if isinstance(other, EncodedNumber)
            else EncodedNumber.encode(self.public_key, other)
        )
        return EncryptedNumber(
            self.public_key,
            self._raw_mul(encoding.encoding),
            self.exponent + encoding.exponent,
        )

    def __rmul__(self, other):
        return self.__mul__(other)

    def __sub__(self, other):
        return self + (other * -1)

    def __rsub__(self, other):
        return other + (self * -1)

    def __truediv__(self, scalar):
        return self.__mul__(1 / scalar)

    def _raw_mul(self, plaintext):
        """c^k mod n^2 for an integer residue k in [0, n).

        Residues in the negative window exponentiate the ciphertext's
        modular inverse by the (short) complement n - k instead — same
        plaintext, exponent the size of the encoded magnitude rather than
        of n (phe/paillier.py:721-751).
        """
        if not isinstance(plaintext, int):
            raise TypeError(
                "the encoded scalar must be an int, got %s" % type(plaintext)
            )
        pub = self.public_key
        if not 0 <= plaintext < pub.n:
            raise ValueError("scalar residue out of range: %i" % plaintext)
        if plaintext >= pub.n - pub.max_int:
            base = invert(self.ciphertext(False), pub.nsquare)
            k = pub.n - plaintext
        else:
            base, k = self.ciphertext(False), plaintext
        return powmod(base, k, pub.nsquare)
