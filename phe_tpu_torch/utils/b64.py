"""base64url integer codecs for the JWK-style key serialisation format.

Reference parity: phe/util.py:165-190 (the jwcrypto-style helpers used by the
CLI's JSON key files, see docs/serialisation.rst:49-135 in the reference).
"""

import base64

__all__ = [
    "base64url_encode",
    "base64url_decode",
    "base64_to_int",
    "int_to_base64",
]


def base64url_encode(payload):
    """URL-safe base64 without padding (reference: phe/util.py:165-169)."""
    if not isinstance(payload, bytes):
        payload = payload.encode("utf-8")
    return base64.urlsafe_b64encode(payload).decode("utf-8").rstrip("=")


def base64url_decode(payload):
    """Inverse of :func:`base64url_encode` (reference: phe/util.py:172-180)."""
    rem = len(payload) % 4
    if rem == 2:
        payload += "=="
    elif rem == 3:
        payload += "="
    elif rem != 0:
        raise ValueError("Invalid base64 string")
    return base64.urlsafe_b64decode(payload.encode("utf-8"))


def base64_to_int(source):
    """Decode a base64url string to a big-endian unsigned integer."""
    return int.from_bytes(base64url_decode(source), "big")


def int_to_base64(source):
    """Encode a positive integer as big-endian base64url (no leading zeros)."""
    assert source != 0
    nbytes = (source.bit_length() + 7) // 8
    return base64url_encode(source.to_bytes(nbytes, "big"))
