"""The port's wire formats (phe_tpu_torch.serial, utils.b64, util) against
phe_tpu's.

On the CPU at a 256-bit key: JWK keys, {"v", "e"} numbers and the vector
format of dump_encrypted_batch are byte-equal to phe_tpu's after
json.dumps on equal inputs (kid given; r pinned: the batches' pinned r, and
for host numbers both keys' get_random_lt_n patched to one value); loads
round-trip, and what one package writes the other loads. At the fixed
8192-bit key, whose ciphertexts pass CPython's 4,300-digit limit on str()
and int(), a ciphertext round-trips on the host, where phe_tpu's
serialiser raises, and the interpreter's limit stays as it was. phe_tpu
runs its RNS engine with the XLA ladder, as tests/test_engine_rns.py sets
it. Tolerance zero throughout.
"""

import json
import random
import sys

import numpy as np
import pytest
import torch

import phe_tpu
from phe_tpu import batch as jbatch
from phe_tpu import serial as jserial
from phe_tpu import util as jutil

import phe_tpu_torch as pt
from phe_tpu_torch import benchmarks, serial, util
from phe_tpu_torch.__about__ import __title__, __version__
from phe_tpu_torch.utils import b64

CPU = torch.device("cpu")
VALUES = [1.5, -2.0, 300.0, 0.0625, 7, -1e-3, 12345.678, 1e-40]
NUMBERS = ["5", "3.1415", "-42.5", "1e-10", "0.0", "1e12", "1e-40"]


@pytest.fixture(autouse=True)
def _force_rns(monkeypatch):
    monkeypatch.setenv("PHE_TPU_ENGINE", "rns")
    monkeypatch.setenv("PHE_TPU_RNS_KERNEL", "xla")


@pytest.fixture(scope="module")
def keys():
    jpub, jpriv = phe_tpu.generate_paillier_keypair(n_length=256)
    pub = pt.PaillierPublicKey(jpub.n)
    return jpub, jpriv, pub, pt.PaillierPrivateKey(pub, jpriv.p, jpriv.q)


@pytest.fixture
def pinned_r(keys, monkeypatch):
    """Both public keys draw the same blinding factor: host obfuscation
    becomes reproducible."""
    jpub, _, pub, _ = keys
    r = 1 + random.Random(5).randrange(pub.n - 1)
    monkeypatch.setattr(jpub, "get_random_lt_n", lambda: r)
    monkeypatch.setattr(pub, "get_random_lt_n", lambda: r)
    return r


def _pinned(pub, count, seed):
    rng = np.random.default_rng(seed)
    return [1 + int.from_bytes(rng.bytes(pub.n.bit_length() // 8 + 8),
                               "little") % (pub.n - 1) for _ in range(count)]


def _dumps(obj):
    return json.dumps(obj)


def test_about_names_the_port():
    assert __title__ == "phe_tpu_torch"
    assert __version__


def test_util_reexports_the_same_names_as_phe_tpu_util():
    names = sorted(n for n in dir(jutil) if not n.startswith("_"))
    assert sorted(n for n in dir(util) if not n.startswith("_")) == names
    assert util.HAVE_NATIVE is pt.utils.ntheory.HAVE_NATIVE
    from phe_tpu import utils as jutils

    assert sorted(pt.utils.__all__) == sorted(jutils.__all__)


@pytest.mark.parametrize("value", [1, 255, 256, 2**64 - 1, 2**2048 + 12345])
def test_b64_codec_equals_phe_tpu(value):
    text = b64.int_to_base64(value)
    assert text == jutil.int_to_base64(value)
    assert b64.base64_to_int(text) == value
    assert b64.base64url_decode(b64.base64url_encode(b"\x00\xffa")) == \
        jutil.base64url_decode(jutil.base64url_encode(b"\x00\xffa"))
    with pytest.raises(ValueError):
        b64.base64url_decode("abcde")


def test_jwk_keys_byte_equal_to_phe_tpu(keys):
    jpub, jpriv, pub, priv = keys
    assert _dumps(serial.public_key_to_jwk(pub, kid="k1")) == _dumps(
        jserial.public_key_to_jwk(jpub, kid="k1"))
    assert _dumps(serial.private_key_to_jwk(priv, kid="k2")) == _dumps(
        jserial.private_key_to_jwk(jpriv, kid="k2"))
    # Without a kid both name the tool and the date in the same words.
    got = serial.private_key_to_jwk(priv)
    want = jserial.private_key_to_jwk(jpriv)
    assert sorted(got) == sorted(want)
    assert got["kid"].rsplit(" on ", 1)[0] == want["kid"].rsplit(" on ", 1)[0]


def test_jwk_written_by_one_package_loads_in_the_other(keys):
    jpub, jpriv, pub, priv = keys
    mine = json.loads(_dumps(serial.private_key_to_jwk(priv)))
    theirs = json.loads(_dumps(jserial.private_key_to_jwk(jpriv)))
    loaded = jserial.private_key_from_jwk(mine)
    assert (loaded.p, loaded.q, loaded.public_key.n) == (priv.p, priv.q,
                                                         pub.n)
    back = serial.private_key_from_jwk(theirs)
    assert back == priv and back.public_key == pub
    assert serial.public_key_from_jwk(theirs["pub"]) == pub
    assert jserial.public_key_from_jwk(mine["pub"]).n == pub.n


@pytest.mark.parametrize("field,value,which", [
    ("alg", "RSA", "pub"), ("kty", "EC", "pub"), ("key_ops", ["encrypt"],
                                                  "priv"),
    ("kty", "EC", "priv"), ("pub", None, "priv"), ("p", None, "priv"),
])
def test_jwk_validation_raises_phe_tpu_messages(keys, field, value, which):
    _, jpriv, _, priv = keys
    bad = serial.private_key_to_jwk(priv, kid="k")
    target = bad["pub"] if which == "pub" else bad
    if value is None:
        del target[field]
    else:
        target[field] = value
    with pytest.raises(AssertionError) as want:
        jserial.private_key_from_jwk(json.loads(_dumps(bad)))
    with pytest.raises(AssertionError) as got:
        serial.private_key_from_jwk(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("text", NUMBERS)
def test_encrypted_number_byte_equal_and_round_trips(keys, pinned_r, text):
    jpub, jpriv, pub, priv = keys
    value = float(text)
    got = serial.dump_encrypted_number(pub.encrypt(value))
    want = jserial.dump_encrypted_number(jpub.encrypt(value))
    assert _dumps(got) == _dumps(want)
    assert got["e"] <= serial.SERIALISED_EXPONENT
    # Unpinned exponents stay as they are.
    assert _dumps(serial.dump_encrypted_number(pub.encrypt(value), False)) \
        == _dumps(jserial.dump_encrypted_number(jpub.encrypt(value), False))
    data = json.loads(_dumps(got))
    assert priv.decrypt(serial.load_encrypted_number(data, pub)) == value
    assert jpriv.decrypt(jserial.load_encrypted_number(data, jpub)) == value


@pytest.mark.parametrize("pin", [True, False])
def test_dump_encrypted_batch_byte_equal_to_phe_tpu(keys, pin):
    jpub, jpriv, pub, priv = keys
    rs = _pinned(pub, len(VALUES), 17)
    mine = pt.EncryptedBatch.encrypt(pub, VALUES, r_values=rs, device=CPU)
    theirs = jbatch.EncryptedBatch.encrypt(jpub, VALUES, r_values=rs)
    got = serial.dump_encrypted_batch(mine, be_secure=False,
                                      pin_exponent=pin)
    want = jserial.dump_encrypted_batch(theirs, be_secure=False,
                                        pin_exponent=pin)
    assert _dumps(got) == _dumps(want)
    if pin:
        assert all(v["e"] <= -32 for v in got["values"])
    # Pinned r is not obfuscated: the dump is the host's raw_encrypt after
    # decrease_exponent_to, element for element.
    for item, value, r in zip(got["values"], VALUES, rs):
        enc = pub.encrypt(value, r_value=r)
        if pin and enc.exponent > -32:
            enc = enc.decrease_exponent_to(-32)
        assert item == {"v": str(enc.ciphertext(be_secure=False)),
                        "e": enc.exponent}


def test_batch_loads_round_trip_across_packages(keys):
    jpub, jpriv, pub, priv = keys
    rs = _pinned(pub, len(VALUES), 18)
    mine = pt.EncryptedBatch.encrypt(pub, VALUES, r_values=rs, device=CPU)
    text = serial.dumps(serial.dump_encrypted_batch(mine, be_secure=False))
    data = serial.loads(text)
    back = serial.load_encrypted_batch(data, pub, device=CPU)
    assert back.mont.device == CPU
    assert [str(c) for c in back.ciphertext_ints(False)] == [
        v["v"] for v in data["values"]]
    assert back.decrypt(priv) == VALUES
    theirs = jserial.load_encrypted_batch(json.loads(text), jpub)
    assert theirs.ciphertext_ints(False) == back.ciphertext_ints(False)
    assert theirs.decrypt(jpriv) == VALUES
    # And phe_tpu's dump loads in the port.
    jtext = jserial.dumps(jserial.dump_encrypted_batch(
        jbatch.EncryptedBatch.encrypt(jpub, VALUES, r_values=rs),
        be_secure=False))
    assert jtext == text
    assert serial.load_encrypted_batch(serial.loads(jtext), pub,
                                       device="cpu").decrypt(priv) == VALUES


def test_secure_batch_dump_is_obfuscated_and_decrypts(keys):
    jpub, jpriv, pub, priv = keys
    rs = _pinned(pub, len(VALUES), 19)
    plain = serial.dump_encrypted_batch(
        pt.EncryptedBatch.encrypt(pub, VALUES, r_values=rs, device=CPU),
        be_secure=False)
    batch = pt.EncryptedBatch.encrypt(pub, VALUES, r_values=rs, device=CPU)
    secure = serial.dump_encrypted_batch(batch)
    assert [v["e"] for v in secure["values"]] == [
        v["e"] for v in plain["values"]]
    assert all(a["v"] != b["v"]
               for a, b in zip(secure["values"], plain["values"]))
    assert [priv.decrypt(serial.load_encrypted_number(v, pub))
            for v in secure["values"]] == VALUES
    assert serial.load_encrypted_batch(secure, pub, device=CPU).decrypt(
        priv) == VALUES
    assert jserial.load_encrypted_batch(secure, jpub).decrypt(jpriv) == VALUES


def test_load_encrypted_batch_defaults_to_the_card(keys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pub = keys[2]
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        serial.load_encrypted_batch({"values": [{"v": "5", "e": 0}]}, pub)


@pytest.mark.parametrize("bits", [1, 7, 64, 4096, 12_000, 12_900, 12_901,
                                  14_200])
def test_decimal_helper_equals_str_and_int_below_the_limit(bits):
    rng = random.Random(bits)
    for _ in range(25):
        value = rng.getrandbits(bits)
        for v in (value, -value):
            try:
                want = str(v)
            except ValueError:  # past the limit: nothing to compare with
                continue
            assert serial.int_to_decimal(v) == want
            assert serial.decimal_to_int(want) == int(want) == v
    assert serial.decimal_to_int(17) == 17
    with pytest.raises(ValueError):
        serial.decimal_to_int("12x")
    with pytest.raises(ValueError):
        serial.decimal_to_int("1" * 5000 + "x")


def test_decimal_helper_past_the_limit_against_chunked_reference():
    limit = sys.get_int_max_str_digits()
    rng = random.Random(3)
    for digits in (limit, limit + 1, 2 * limit + 7, 10_000):
        text = str(rng.randrange(1, 10)) + "".join(
            str(rng.randrange(10)) for _ in range(digits - 1))
        # The value of the digits, built by hand in chunks of 1,000.
        value = 0
        for i in range(0, len(text), 1000):
            chunk = text[i : i + 1000]
            value = value * 10 ** len(chunk) + int(chunk)
        assert serial.decimal_to_int(text) == value
        assert serial.int_to_decimal(value) == text
        assert serial.decimal_to_int("-" + text) == -value
        assert serial.int_to_decimal(-value) == "-" + text
    assert sys.get_int_max_str_digits() == limit


def test_8192_bit_ciphertext_round_trips_past_the_digit_limit():
    limit = sys.get_int_max_str_digits()
    pub, priv = benchmarks.fixed_key(8192)
    enc = pub.encrypt(-1234.5625)
    data = serial.dump_encrypted_number(enc)
    assert len(data["v"]) > 4300 and data["e"] == -32
    text = serial.dumps(data)
    back = serial.load_encrypted_number(serial.loads(text), pub)
    assert back.ciphertext(be_secure=False) == serial.decimal_to_int(
        data["v"])
    assert priv.decrypt(back) == -1234.5625
    # phe_tpu's str() refuses the same ciphertext.
    jpub = phe_tpu.PaillierPublicKey(pub.n)
    jenc = phe_tpu.EncryptedNumber(jpub, back.ciphertext(be_secure=False),
                                   data["e"])
    with pytest.raises(ValueError, match="Exceeds the limit"):
        jserial.dump_encrypted_number(jenc)
    assert sys.get_int_max_str_digits() == limit
