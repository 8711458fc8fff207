"""Key and ciphertext serialisation: JWK-style JSON, wire-compatible with phe.

The port of phe_tpu/serial.py, with the same formats (the reference keeps
them inside its CLI: phe/command_line.py:46-61 keys, :120-131
ciphertexts; spec prose in docs/serialisation.rst:49-135):

* public key:  {"kty": "DAJ", "alg": "PAI-GN1", "key_ops": ["encrypt"],
                "n": base64url, "kid": ...}
* private key: {"kty": "DAJ", "key_ops": ["decrypt"], "p": b64, "q": b64,
                "pub": <public jwk>, "kid": ...}
* ciphertext:  {"v": "<decimal int>", "e": exponent}, exponent pinned to
               -32 when above it (phe/command_line.py:120-131).

Batch extensions: ``dump_encrypted_batch`` / ``load_encrypted_batch``
serialise a whole EncryptedBatch as the documented share-the-key-once
vector format (docs/serialisation.rst:24-43): a list of (ciphertext,
exponent) pairs under one public key. The batch is pinned to -32 in one
per-element modexp on its device, and loaded onto the card unless the
caller asks for another device.

Ciphertexts travel as decimal strings. CPython (3.11 on) refuses str() and
int() of an integer past ``sys.get_int_max_str_digits()`` decimal digits
(4,300 by default), which a ciphertext of a key above about 7,142 bits
passes; phe_tpu's str() / int() raise there. ``int_to_decimal`` and
``decimal_to_int`` give exactly what str() and int() give wherever those
work, and convert longer values in chunks under the limit, which they
leave as it is.
"""

import datetime
import functools
import json
import re
import sys

from phe_tpu_torch.keys import PaillierPrivateKey, PaillierPublicKey
from phe_tpu_torch.utils.b64 import base64_to_int, int_to_base64

SERIALISED_EXPONENT = -32  # phe/command_line.py:121-125

_DECIMAL = re.compile(r"-?[0-9]+")


def _digit_limit():
    """The interpreter's str()/int() digit limit; 0 when there is none."""
    get = getattr(sys, "get_int_max_str_digits", None)
    return get() if get is not None else 0


@functools.lru_cache(maxsize=256)
def _pow10(k):
    return 10**k


def _to_decimal(value, limit):
    # value >= 0. 3 * limit bits are fewer than 0.91 * limit digits.
    if value.bit_length() <= 3 * limit:
        return str(value)
    k = value.bit_length() * 30103 // 200000  # half its digits, or fewer
    hi, lo = divmod(value, _pow10(k))
    return _to_decimal(hi, limit) + _to_decimal(lo, limit).zfill(k)


def _from_decimal(digits, limit):
    if len(digits) <= limit:
        return int(digits)
    k = len(digits) // 2
    return (_from_decimal(digits[:-k], limit) * _pow10(k)
            + _from_decimal(digits[-k:], limit))


def int_to_decimal(value):
    """str(value) for an int of any size, the interpreter's limit unchanged."""
    limit = _digit_limit()
    if not limit or value.bit_length() <= 3 * limit:
        return str(value)
    if value < 0:
        return "-" + _to_decimal(-value, limit)
    return _to_decimal(value, limit)


def decimal_to_int(text):
    """int(text) for a decimal string of any length (an int passes as is).

    Strings within the interpreter's digit limit go to int() itself;
    longer ones must be an optional "-" and ASCII digits.
    """
    if isinstance(text, int):
        return int(text)
    limit = _digit_limit()
    if not limit or len(text) <= limit:
        return int(text)
    if not _DECIMAL.fullmatch(text):
        raise ValueError("invalid decimal integer of %d characters"
                         % len(text))
    if text[0] == "-":
        return -_from_decimal(text[1:], limit)
    return _from_decimal(text, limit)


def public_key_to_jwk(public_key, kid=None):
    """JWK dict for a public key (format: phe/command_line.py:46-52)."""
    if kid is None:
        date = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        kid = "Paillier public key generated by pheutil on {}".format(date)
    return {
        "kty": "DAJ",
        "alg": "PAI-GN1",
        "key_ops": ["encrypt"],
        "n": int_to_base64(public_key.n),
        "kid": kid,
    }


def private_key_to_jwk(private_key, kid=None):
    """JWK dict for a private key (format: phe/command_line.py:54-61)."""
    if kid is None:
        date = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        kid = "Paillier private key generated by pheutil on {}".format(date)
    return {
        "kty": "DAJ",
        "key_ops": ["decrypt"],
        "p": int_to_base64(private_key.p),
        "q": int_to_base64(private_key.q),
        "pub": public_key_to_jwk(private_key.public_key),
        "kid": kid,
    }


def public_key_from_jwk(data):
    """Validate and load a public-key JWK (phe/command_line.py:256-264)."""
    error_msg = "Invalid public key"
    assert "alg" in data, error_msg
    assert data["alg"] == "PAI-GN1", error_msg
    assert data["kty"] == "DAJ", error_msg
    return PaillierPublicKey(base64_to_int(data["n"]))


def private_key_from_jwk(data):
    """Validate and load a private-key JWK (phe/command_line.py:145-160)."""
    assert "pub" in data, "Invalid private key"
    public_key = public_key_from_jwk(data["pub"])
    error_msg = "Invalid private key"
    assert "key_ops" in data, error_msg
    assert "decrypt" in data["key_ops"], error_msg
    assert "p" in data, error_msg
    assert "q" in data, error_msg
    assert data["kty"] == "DAJ", error_msg
    return PaillierPrivateKey(
        public_key, base64_to_int(data["p"]), base64_to_int(data["q"])
    )


def dump_encrypted_number(enc, pin_exponent=True):
    """{"v", "e"} dict; exponent pinned to -32 from above when pin_exponent.

    Pinning hides information the exponent would leak about the plaintext's
    magnitude (phe/command_line.py:120-131). Exponents already below -32
    are left as-is, like the reference.
    """
    if pin_exponent and enc.exponent > SERIALISED_EXPONENT:
        enc = enc.decrease_exponent_to(SERIALISED_EXPONENT)
    return {"v": int_to_decimal(enc.ciphertext()), "e": enc.exponent}


def load_encrypted_number(data, public_key):
    """EncryptedNumber from a {"v", "e"} dict (phe/command_line.py:267-276)."""
    from phe_tpu_torch.encrypted import EncryptedNumber

    assert "v" in data
    assert "e" in data
    return EncryptedNumber(public_key, decimal_to_int(data["v"]),
                           exponent=data["e"])


def dump_encrypted_batch(batch, be_secure=True, pin_exponent=True):
    """Vector wire format: {"values": [{"v","e"}, ...]} sharing one key.

    The documented way to serialise many ciphertexts (reference
    docs/serialisation.rst:24-43: share the public key once, send
    (ciphertext, exponent) pairs). Exponent pinning runs as one
    per-element modexp on the batch's device (decrease_exponent_to), and
    be_secure re-obfuscates there before the export.
    """
    if pin_exponent:
        target = [min(int(e), SERIALISED_EXPONENT) for e in batch.exponents]
        batch = batch.decrease_exponent_to(target)
    cts = batch.ciphertext_ints(be_secure=be_secure)
    return {
        "values": [
            {"v": int_to_decimal(c), "e": int(e)}
            for c, e in zip(cts, batch.exponents)
        ]
    }


def load_encrypted_batch(data, public_key, device=None):
    """EncryptedBatch on ``device`` (None: the card) from the vector wire
    format."""
    from phe_tpu_torch.batch import EncryptedBatch

    pairs = data["values"]
    return EncryptedBatch.from_ciphertext_ints(
        public_key,
        [decimal_to_int(item["v"]) for item in pairs],
        [int(item["e"]) for item in pairs],
        device=device,
    )


def dumps(obj):
    return json.dumps(obj)


def loads(text):
    return json.loads(text)
