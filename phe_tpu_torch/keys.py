"""Key material for the Paillier engine: generation, trapdoor, keyring.

This is the host-side key layer. It owns everything that happens once per
key — prime search, trapdoor precomputation, random blinding draws — and
hands per-key device constants to the batch engine lazily through
``device_context(device)``, one context per device. Scalar encrypt/decrypt on host integers lives here
too, both as the small-n fallback and as the independent oracle the device
kernels are tested against.

Numeric semantics are pinned to the reference implementation
(phe/paillier.py; regression vectors phe/tests/paillier_test.py:128-149):
the simple-variant generator g = n+1, max_int = n//3 - 1, keygen retrying
until the modulus hits the requested bit length exactly, and CRT
decryption. The code below is this framework's own expression of that
contract — see phe_tpu_torch.batch for the batched device form of the same math.
"""

import secrets
from collections.abc import Mapping

from phe_tpu_torch import config as _config
from phe_tpu_torch.encoding import EncodedNumber
from phe_tpu_torch.utils.ntheory import getprimeover, invert, isqrt, mulmod, powmod

#: Default modulus size in bits (>= 128-bit security level).
DEFAULT_KEYSIZE = 3072


def generate_paillier_keypair(private_keyring=None, n_length=DEFAULT_KEYSIZE):
    """Draw a fresh Paillier keypair with an exactly n_length-bit modulus.

    Two independent primes of n_length/2 bits each; the draw repeats until
    they differ and their product has the requested bit length (the product
    of two k-bit primes has 2k or 2k-1 bits). Registers the private key on
    ``private_keyring`` when one is given. Returns (public, private).
    """
    half = n_length // 2
    while True:
        p = getprimeover(half)
        q = getprimeover(half)
        if p != q and (p * q).bit_length() == n_length:
            break

    public = PaillierPublicKey(p * q)
    private = PaillierPrivateKey(public, p, q)
    if private_keyring is not None:
        private_keyring.add(private)
    return public, private


def _ell(x, d):
    """Paillier's L function: the integer quotient (x - 1) / d.

    Well-defined on the image of the decryption exponentials, where
    x = 1 (mod d) always holds.
    """
    return (x - 1) // d


def _crt_constant(g, d, dsquare):
    """h_d = L(g^(d-1) mod d^2, d)^-1 mod d, one CRT leg's decrypt factor."""
    return invert(_ell(powmod(g, d - 1, dsquare), d), d)


class PaillierPublicKey(object):
    """The encryption half of a Paillier keypair.

    Carries the modulus ``n`` and everything derived from it that
    encryption and the homomorphic algebra need: ``g = n + 1`` (the
    simple-variant generator whose power is a closed form, no modexp),
    ``nsquare`` (the ciphertext ring), and ``max_int = n//3 - 1`` (the
    magnitude bound splitting the plaintext ring into a positive window,
    a negative window and a detectable-overflow gap; see
    phe_tpu_torch.encoding). Two public keys are interchangeable iff their
    moduli match, so equality and hashing go through ``n``.
    """

    def __init__(self, n):
        self.n = n
        self.g = n + 1
        self.nsquare = n * n
        self.max_int = n // 3 - 1
        self._device_contexts = {}

    def __repr__(self):
        return "<PaillierPublicKey {}>".format(hex(hash(self))[2:][:10])

    def __eq__(self, other):
        return self.n == other.n

    def __hash__(self):
        return hash(self.n)

    def device_context(self, device=None):
        """This key's device constants on ``device`` (lazy, cached per device).

        device: None for CUDA, or any torch device ("cpu" for the plain
        PyTorch versions of the kernels).
        """
        dev = _config.resolve_device(device)
        if dev not in self._device_contexts:
            from phe_tpu_torch.batch import PublicDeviceContext

            self._device_contexts[dev] = PublicDeviceContext.build(self, dev)
        return self._device_contexts[dev]

    def get_random_lt_n(self):
        """A blinding factor: uniform from the system CSPRNG in [1, n)."""
        return 1 + secrets.randbelow(self.n - 1)

    def _nude_ciphertext(self, residue):
        """g^residue mod n^2, unblinded, for a residue in [0, n).

        With g = n+1 the power collapses to 1 + n*residue (binomial
        expansion mod n^2; phe/paillier.py:132-134). Residues in the
        negative window are routed through the modular inverse of their
        complement's ciphertext so every intermediate integer stays near
        n rather than n^2 (the reference's "inverse trick", :125-130).
        """
        negative = self.n - self.max_int <= residue < self.n
        m = self.n - residue if negative else residue
        c = (1 + self.n * m) % self.nsquare
        return invert(c, self.nsquare) if negative else c

    def raw_encrypt(self, plaintext, r_value=None):
        """Encrypt an integer residue: g^m * r^n mod n^2.

        ``r_value`` pins the blinding factor (tests, interop vectors);
        by default a fresh CSPRNG draw is used. The r^n modexp is the
        whole cost of an encryption — batched workloads should go through
        phe_tpu_torch.batch, which runs it on the GPU for the entire batch.
        """
        if not isinstance(plaintext, int):
            raise TypeError(
                "plaintext must already be encoded to int, got %s"
                % type(plaintext)
            )
        r = r_value or self.get_random_lt_n()
        blind = powmod(r, self.n, self.nsquare)
        return mulmod(self._nude_ciphertext(plaintext), blind, self.nsquare)

    def encrypt(self, value, precision=None, r_value=None):
        """Encode (unless already encoded) and encrypt one number."""
        encoding = (
            value
            if isinstance(value, EncodedNumber)
            else EncodedNumber.encode(self, value, precision)
        )
        return self.encrypt_encoded(encoding, r_value)

    def encrypt_encoded(self, encoding, r_value):
        """Encrypt an EncodedNumber into an EncryptedNumber.

        Without a pinned r the blinding is applied through
        EncryptedNumber.obfuscate so the lazy-obfuscation state machine
        starts in the "fresh" state (phe/paillier.py:177-194 semantics).
        """
        from phe_tpu_torch.encrypted import EncryptedNumber

        ciphertext = self.raw_encrypt(encoding.encoding, r_value=r_value or 1)
        number = EncryptedNumber(self, ciphertext, encoding.exponent)
        if r_value is None:
            number.obfuscate()
        return number


class PaillierPrivateKey(object):
    """The trapdoor half: the factorisation of n plus CRT decrypt state.

    Decryption runs one exponentiation per prime-square ring (exponents
    p-1 and q-1, half the width of n) and recombines by CRT — the layout
    the device decrypt pipeline mirrors limb-for-limb
    (phe_tpu_torch.batch._decrypt_residue_rns). Precomputed here, reused everywhere:
    ``psquare``/``qsquare``, ``p_inverse`` (p^-1 mod q) and the per-leg
    factors ``hp``/``hq``. The factors are normalised so p < q. Equality
    and hashing go through the factor pair.
    """

    def __init__(self, public_key, p, q):
        if p * q != public_key.n:
            raise ValueError("the factors given do not multiply to n")
        if p == q:
            raise ValueError("the two factors must be distinct primes")
        self.public_key = public_key
        self.p, self.q = min(p, q), max(p, q)
        self.psquare = self.p * self.p
        self.qsquare = self.q * self.q
        self.p_inverse = invert(self.p, self.q)
        self.hp = _crt_constant(public_key.g, self.p, self.psquare)
        self.hq = _crt_constant(public_key.g, self.q, self.qsquare)
        self._device_contexts = {}

    @staticmethod
    def from_totient(public_key, totient):
        """Rebuild the factors from Euler's totient of n.

        p and q are the roots of x^2 - s*x + n with s = p + q
        = n - totient + 1, recovered by integer square root
        (phe/paillier.py:237-262 semantics).
        """
        s = public_key.n - totient + 1
        gap = isqrt(s * s - 4 * public_key.n)
        p = (s - gap) // 2
        q = s - p
        if p * q != public_key.n:
            raise ValueError("the totient does not belong to this modulus")
        return PaillierPrivateKey(public_key, p, q)

    def __repr__(self):
        return "<PaillierPrivateKey for {}>".format(repr(self.public_key))

    def __eq__(self, other):
        return self.p == other.p and self.q == other.q

    def __hash__(self):
        return hash((self.p, self.q))

    def device_context(self, device=None):
        """This key's CRT device constants on ``device`` (lazy, per device)."""
        dev = _config.resolve_device(device)
        if dev not in self._device_contexts:
            from phe_tpu_torch.batch import PrivateDeviceContext

            self._device_contexts[dev] = PrivateDeviceContext.build(
                self, dev)
        return self._device_contexts[dev]

    def _half_decrypt(self, ciphertext, d, dsquare, h):
        """One CRT leg: m mod d = L(c^(d-1) mod d^2, d) * h_d mod d."""
        return mulmod(_ell(powmod(ciphertext, d - 1, dsquare), d), h, d)

    def raw_decrypt(self, ciphertext):
        """Plaintext residue in [0, n) of a raw integer ciphertext."""
        if not isinstance(ciphertext, int):
            raise TypeError(
                "ciphertext must be an int, got %s" % type(ciphertext)
            )
        mp = self._half_decrypt(ciphertext, self.p, self.psquare, self.hp)
        mq = self._half_decrypt(ciphertext, self.q, self.qsquare, self.hq)
        # CRT lift: add the multiple of p that moves mp onto mq mod q.
        return mp + mulmod(mq - mp, self.p_inverse, self.q) * self.p

    def decrypt(self, encrypted_number):
        """Decrypt and decode back to the original int/float."""
        return self.decrypt_encoded(encrypted_number).decode()

    def decrypt_encoded(self, encrypted_number, Encoding=None):
        """Decrypt to an EncodedNumber, optionally of a custom Encoding.

        ``Encoding`` supports alternative-base encodings
        (examples/alternative_base.py). Reads the ciphertext with
        be_secure=False: decryption happens inside the trust boundary, so
        no blinding is spent on it.
        """
        from phe_tpu_torch.encrypted import EncryptedNumber

        if not isinstance(encrypted_number, EncryptedNumber):
            raise TypeError(
                "decrypt expects an EncryptedNumber, got %s"
                % type(encrypted_number)
            )
        if self.public_key != encrypted_number.public_key:
            raise ValueError(
                "this key cannot decrypt a ciphertext made under a "
                "different public key"
            )
        if Encoding is None:
            Encoding = EncodedNumber
        residue = self.raw_decrypt(encrypted_number.ciphertext(be_secure=False))
        return Encoding(self.public_key, residue, encrypted_number.exponent)


class PaillierPrivateKeyring(Mapping):
    """A read-mostly mapping from public key to its private key.

    Lets multi-key services route ciphertexts to the right trapdoor:
    ``ring.decrypt(enc)`` looks up ``enc.public_key``. Mapping semantics
    (len/iter/getitem over public keys) per phe/paillier.py:383-439.
    """

    def __init__(self, private_keys=None):
        self._by_public = {}
        for key in private_keys or []:
            self.add(key)

    def __getitem__(self, public_key):
        return self._by_public[public_key]

    def __len__(self):
        return len(self._by_public)

    def __iter__(self):
        return iter(self._by_public)

    def __delitem__(self, public_key):
        del self._by_public[public_key]

    def add(self, private_key):
        """Register a private key under its own public key."""
        if not isinstance(private_key, PaillierPrivateKey):
            raise TypeError(
                "only PaillierPrivateKey objects belong on a keyring, "
                "got %s" % type(private_key)
            )
        self._by_public[private_key.public_key] = private_key

    def decrypt(self, encrypted_number):
        """Decrypt with the stored key matching the ciphertext's."""
        return self._by_public[encrypted_number.public_key].decrypt(
            encrypted_number
        )
