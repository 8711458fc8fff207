"""Host-side exact number theory for key generation and scalar paths.

Prime search, modular inverses and exact modular exponentiation over
CPython's arbitrary-precision integers. The batched hot path lives in
:mod:`phe_tpu_torch.ops` as PyTorch code and CUDA kernels; nothing here is
called per ciphertext element in the batch API.

Semantics parity: mirrors the reference backend dispatch surface of
``phe/util.py`` (powmod :38-50, mulmod :53-64, invert :85-103,
getprimeover :106-124, isqrt :127-132, miller_rabin :381-418, is_prime
:421-443) with identical exception types and probabilistic guarantees.
powmod and Miller-Rabin go to the native C++ engine
(phe_tpu_torch.native) for odd moduli from 512 bits, where it built, as
the reference sends them to gmpy2; everything else runs on CPython ints
(the reference's own fallback backend).
"""

import math
import random
import secrets

from phe_tpu_torch import native as _native

# Import-time backend detection, as the reference does for gmpy2.
HAVE_NATIVE = _native.HAVE_NATIVE

# Below this modulus size CPython's pow wins (call overhead dominates);
# mirrors the reference's _USE_MOD_FROM_GMP_SIZE threshold (phe/util.py:33).
_USE_NATIVE_FROM_BITS = 512

__all__ = [
    "HAVE_NATIVE",
    "powmod",
    "mulmod",
    "invert",
    "extended_euclidean_algorithm",
    "getprimeover",
    "isqrt",
    "is_prime",
    "miller_rabin",
    "first_primes",
    "SMALL_PRIME_BOUND",
]

# Sieve bound chosen to match the reference's hardcoded small-prime table
# (phe/util.py:195-378 ends at 17863; the next prime is 17881).
SMALL_PRIME_BOUND = 17880


def _sieve(bound):
    """Primes <= bound by sieve of Eratosthenes (computed once at import)."""
    flags = bytearray([1]) * (bound + 1)
    flags[0] = flags[1] = 0
    for i in range(2, math.isqrt(bound) + 1):
        if flags[i]:
            flags[i * i :: i] = bytearray(len(flags[i * i :: i]))
    return [i for i, f in enumerate(flags) if f]


first_primes = _sieve(SMALL_PRIME_BOUND)
_first_primes_set = frozenset(first_primes)


def powmod(a, b, c):
    """a**b mod c on host ints (reference: phe/util.py:38-50).

    Dispatches to the C++ Montgomery engine for large odd moduli, the role
    gmpy2.powmod plays for the reference, and to CPython's pow otherwise.
    """
    if a == 1:
        return 1
    if (
        HAVE_NATIVE
        and b >= 0
        and (c & 1)
        and _USE_NATIVE_FROM_BITS <= c.bit_length() <= _native.MAX_MODULUS_BITS
    ):
        return _native.powmod(a, b, c)
    return pow(a, b, c)


def mulmod(a, b, c):
    """a*b mod c on host ints (reference: phe/util.py:53-64)."""
    return a * b % c


def extended_euclidean_algorithm(a, b):
    """Return (g, x, y) with g = gcd(a, b) = x*a + y*b.

    Reference: phe/util.py:67-82.
    """
    old_r, r = a, b
    old_x, x = 1, 0
    old_y, y = 0, 1
    while r != 0:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_x, x = x, old_x - q * x
        old_y, y = y, old_y - q * y
    return old_r, old_x, old_y


def invert(a, b):
    """Multiplicative inverse of a modulo b.

    Raises ZeroDivisionError when no inverse exists, matching the reference
    (phe/util.py:85-103).
    """
    try:
        return pow(a, -1, b)
    except ValueError as e:
        raise ZeroDivisionError("invert() no inverse exists") from e


def isqrt(n):
    """Integer square root (reference: phe/util.py:127-132)."""
    return math.isqrt(n)


def miller_rabin(n, k):
    """Miller-Rabin with k random witnesses (reference: phe/util.py:381-418).

    Returns True for probable primes (error probability < 4**-k), False for
    proven composites. Requires n > 3.
    """
    if n <= 3:
        raise ValueError("miller_rabin needs n > 3")
    witnesses = [random.randint(2, n - 2) for _ in range(k)]
    if (
        HAVE_NATIVE
        and _USE_NATIVE_FROM_BITS <= n.bit_length() <= _native.MAX_MODULUS_BITS
    ):
        return _native.miller_rabin_native(n, witnesses)

    d = n - 1
    r = 0
    while d & 1 == 0:
        d >>= 1
        r += 1

    for a in witnesses:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def is_prime(n, mr_rounds=25):
    """Probabilistic primality test (reference: phe/util.py:421-443).

    Small candidates are answered exactly from the sieve; otherwise trial
    division by the sieve primes, then Miller-Rabin with mr_rounds witnesses
    (25 matches GMP's default, giving false-prime probability < 2^-50).
    """
    if n <= first_primes[-1]:
        return n in _first_primes_set
    for p in first_primes:
        if n % p == 0:
            return False
    return miller_rabin(n, mr_rounds)


def getprimeover(n_bits):
    """Random prime with exactly n_bits bits from the system CSPRNG.

    Reference: phe/util.py:106-124 (pure-Python branch :119-124): draw a
    random odd n_bits-bit integer and walk upward to the next prime.
    """
    candidate = (secrets.randbits(n_bits - 1) | (1 << (n_bits - 1))) | 1
    while not is_prime(candidate):
        candidate += 2
    return candidate
