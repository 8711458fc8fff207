"""Compatibility alias for the reference's ``phe.util`` module surface.

The reference re-exports ``phe.util`` (phe/__init__.py:7) with powmod /
mulmod / invert / getprimeover / isqrt / miller_rabin / is_prime /
extended_euclidean_algorithm plus the base64url JWK codec
(phe/util.py:165-190), as phe_tpu's ``phe_tpu.util`` does. Code written
against ``phe.util`` can switch to ``phe_tpu_torch.util`` unchanged; the
implementations live in phe_tpu_torch.utils.ntheory (number theory, with
the native host engine behind HAVE_NATIVE) and phe_tpu_torch.utils.b64
(codec).
"""

from phe_tpu_torch.utils.b64 import (  # noqa: F401
    base64_to_int,
    base64url_decode,
    base64url_encode,
    int_to_base64,
)
from phe_tpu_torch.utils.ntheory import (  # noqa: F401
    HAVE_NATIVE,
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
