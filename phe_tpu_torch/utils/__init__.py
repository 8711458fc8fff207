"""Host-side utilities: exact number theory, base64 codecs, limb packing."""

from phe_tpu_torch.utils.b64 import (
    base64_to_int,
    base64url_decode,
    base64url_encode,
    int_to_base64,
)
from phe_tpu_torch.utils.ntheory import (
    extended_euclidean_algorithm,
    first_primes,
    getprimeover,
    invert,
    is_prime,
    isqrt,
    miller_rabin,
    mulmod,
    powmod,
)

__all__ = [
    "base64_to_int",
    "base64url_decode",
    "base64url_encode",
    "int_to_base64",
    "extended_euclidean_algorithm",
    "first_primes",
    "getprimeover",
    "invert",
    "is_prime",
    "isqrt",
    "miller_rabin",
    "mulmod",
    "powmod",
]
