"""The port's encrypt -> secure export -> decrypt slice against phe_tpu.

On the CPU, at 256-bit keys, phe_tpu runs its RNS engine with the XLA
ladder (PHE_TPU_ENGINE=rns, PHE_TPU_RNS_KERNEL=xla, as
tests/test_engine_rns.py sets them) and phe_tpu_torch its plain PyTorch
versions. Ciphertext ints, compact-decode rows and decrypted values are
equal (tolerance zero: all exact integer arithmetic), every host builder
of the slice is array-equal at 256 bits and at the fixed 2048-bit key,
and Montgomery rows carried across with interop decrypt in both
directions. One 2-row round trip runs at the production 2048-bit geometry
against the host-integer oracle. phe_tpu's programs are jitted once per
shape and read its engine knobs outside the traced code, so the fixtures
below set the knobs before anything is traced.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phe_tpu
from phe_tpu import batch as jbatch
from phe_tpu.encoding import EncodedNumber as JEncoded

import phe_tpu_torch as pt
from phe_tpu_torch import batch as tbatch
from phe_tpu_torch import interop
from __graft_entry__ import _P, _Q

CPU = torch.device("cpu")

VALUES = [0, 1, -1, 3.14159, -2.5e-3, 1 << 60, 17.5, -(1 << 100),
          1 << 200, 2.0 ** -1000, -123456.789]


@pytest.fixture(autouse=True)
def _force_rns(monkeypatch):
    monkeypatch.setenv("PHE_TPU_ENGINE", "rns")
    monkeypatch.setenv("PHE_TPU_RNS_KERNEL", "xla")


def _pair(jpub, jpriv):
    pub = pt.PaillierPublicKey(jpub.n)
    return pub, pt.PaillierPrivateKey(pub, jpriv.p, jpriv.q)


@pytest.fixture(scope="module")
def keys():
    jpub, jpriv = phe_tpu.generate_paillier_keypair(n_length=256)
    return (jpub, jpriv) + _pair(jpub, jpriv)


def _pinned(pub, count, seed):
    rng = np.random.default_rng(seed)
    return [1 + int.from_bytes(rng.bytes(pub.n.bit_length() // 8 + 8),
                               "little") % (pub.n - 1) for _ in range(count)]


def _to_dict(x):
    """A phe_tpu structure as the dict of numpy arrays interop takes."""
    if hasattr(x, "_fields"):
        return {f: _to_dict(getattr(x, f)) for f in x._fields
                if getattr(x, f) is not None}
    return np.asarray(x)


def _equal(got, want):
    """Port structure == interop's copy of phe_tpu's, field by field."""
    if hasattr(got, "_fields"):
        for f in got._fields:
            _equal(getattr(got, f), getattr(want, f))
    elif torch.is_tensor(got):
        assert got.dtype == want.dtype and torch.equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("bits", [256, 2048])
def test_slice_builders_array_equal(monkeypatch, bits):
    if bits == 2048:
        jpub = phe_tpu.PaillierPublicKey(_P * _Q)
        jpriv = phe_tpu.PaillierPrivateKey(jpub, _P, _Q)
    else:
        jpub, jpriv = phe_tpu.generate_paillier_keypair(n_length=256)
    pub, priv = _pair(jpub, jpriv)
    jdc, dc = jpub.device_context(), pub.device_context("cpu")
    _equal(dc.ctx, interop.montgomery_context(_to_dict(jdc.ctx), CPU))
    assert (dc.L, dc.Ln) == (jdc.L, jdc.Ln)
    for name in ("nr2_limbs", "n_digits"):
        assert torch.equal(getattr(dc, name), torch.as_tensor(
            np.asarray(getattr(jdc, name)).astype(np.int64))), name
    st, jst = dc.rns_state(), jdc.rns_state()
    _equal(st.rsys, interop.rns_system(_to_dict(jst.rsys), CPU))
    _equal(st.conv, interop.rns_conversion(_to_dict(jst.conv), CPU))
    _equal(st.red, interop.excess_reducer(_to_dict(jst.red), CPU))
    assert torch.equal(st.exit_r, torch.as_tensor(
        np.asarray(jst.exit_r).astype(np.int64)))
    pdc, jpdc = priv.device_context("cpu"), jpriv.device_context()
    _equal(pdc.consts, interop.private_device_constants(
        _to_dict(jpdc.consts), CPU))
    for half, jhalf in zip(pdc.rns_state(), jpdc.rns_state()):
        _equal(half[0], interop.rns_system(_to_dict(jhalf[0]), CPU))
        _equal(half[1], interop.rns_conversion(_to_dict(jhalf[1]), CPU))
        assert torch.equal(half[2], torch.as_tensor(
            np.asarray(jhalf[2]).astype(np.int64)))
        _equal(half[3], interop.excess_reducer(_to_dict(jhalf[3]), CPU))
    if bits == 2048:
        assert (st.rsys.k, st.rsys.cpad, dc.L) == (304, 616, 296)
        assert [h[0].k for h in pdc.rns_state()] == [152, 152]


def test_pinned_ciphertexts_equal_phe_tpu_and_raw_encrypt(keys):
    jpub, jpriv, pub, priv = keys
    encs = [JEncoded.encode(jpub, v) for v in VALUES]
    rs = _pinned(pub, len(VALUES), 51)
    got = pt.EncryptedBatch.encrypt(pub, VALUES, r_values=rs, device="cpu")
    want = jbatch.EncryptedBatch.encrypt(jpub, VALUES, r_values=rs)
    ints = got.ciphertext_ints(be_secure=False)
    assert ints == want.ciphertext_ints(be_secure=False)
    assert ints == [jpub.raw_encrypt(e.encoding, r_value=r)
                    for e, r in zip(encs, rs)]
    assert not got.is_obfuscated
    assert list(got.exponents) == [e.exponent for e in encs]


def test_compact_rows_and_decrypt_equal_phe_tpu(keys):
    jpub, jpriv, pub, priv = keys
    rs = _pinned(pub, len(VALUES), 52)
    got = pt.EncryptedBatch.encrypt(pub, VALUES, r_values=rs, device="cpu")
    want = jbatch.EncryptedBatch.encrypt(jpub, VALUES, r_values=rs)
    compact, full = priv.device_context("cpu").raw_decrypt_compact(got.mont)
    jcompact, jfull = jpriv.device_context().raw_decrypt_compact(want.mont)
    np.testing.assert_array_equal(compact.numpy(),
                                  np.asarray(jcompact).astype(np.int64))
    np.testing.assert_array_equal(full.numpy(), np.asarray(jfull))
    out = got.decrypt(priv)
    assert out == want.decrypt(jpriv) == VALUES
    assert priv.device_context("cpu").raw_decrypt_batch(got.mont)[
        : len(VALUES)] == [e.encoding for e in
                           pt.EncodedNumber.encode_many(pub, VALUES)]


def test_interop_rows_decrypt_both_ways(keys):
    jpub, jpriv, pub, priv = keys
    mine = pt.EncryptedBatch.encrypt(pub, VALUES, device="cpu")
    theirs = jbatch.EncryptedBatch.encrypt(jpub, VALUES)
    carried = interop.batch_from_limbs(pub, np.asarray(theirs.mont),
                                       theirs.exponents, device="cpu")
    assert carried.decrypt(priv) == VALUES
    back = jbatch.EncryptedBatch(
        jpub, jnp.asarray(mine.mont.numpy().astype(np.uint32)),
        mine.exponents)
    assert back.decrypt(jpriv) == VALUES
    with pytest.raises(ValueError, match="Montgomery rows"):
        interop.batch_from_limbs(pub, np.zeros((4, 3), np.uint32), [0] * 4,
                                 device="cpu")


def test_secure_export_obfuscate_and_import(keys):
    jpub, jpriv, pub, priv = keys
    rs = _pinned(pub, len(VALUES), 53)
    batch = pt.EncryptedBatch.encrypt(pub, VALUES, r_values=rs, device="cpu")
    raw = batch.ciphertext_ints(be_secure=False)
    secure = batch.ciphertext_ints()
    assert batch.is_obfuscated and secure != raw
    assert batch.ciphertext_ints() == secure  # obfuscation sticks
    assert [priv.decrypt(pt.EncryptedNumber(pub, c, int(e)))
            for c, e in zip(secure, batch.exponents)] == VALUES
    again = batch.obfuscate()
    assert again.is_obfuscated and again.decrypt(priv) == VALUES
    imported = pt.EncryptedBatch.from_ciphertext_ints(
        pub, secure, batch.exponents, device="cpu")
    assert len(imported) == len(VALUES)
    assert imported.ciphertext_ints(be_secure=False) == secure
    finish = imported.decrypt_async(priv)
    assert callable(finish) and finish() == VALUES
    _, other = pt.generate_paillier_keypair(n_length=256)
    with pytest.raises(ValueError, match="different key"):
        imported.decrypt(other)


def test_fresh_encrypt_and_custom_encoding(keys):
    jpub, jpriv, pub, priv = keys

    class Base64(pt.EncodedNumber):
        BASE = 64
        LOG2_BASE = 6.0

    fresh = pt.EncryptedBatch.encrypt(pub, VALUES, device="cpu")
    assert fresh.is_obfuscated and len(fresh) == len(VALUES)
    assert fresh.mont.shape == (tbatch.bucket_rows(len(VALUES)),
                                fresh._dc.L)
    assert fresh.decrypt(priv) == VALUES
    enc = [Base64.encode(pub, v) for v in VALUES[:5]]
    b = pt.EncryptedBatch.encrypt(pub, enc, precision=1e-6, device="cpu")
    assert b.decrypt(priv, Encoding=Base64) == [e.decode() for e in enc]


def test_reference_regression_vector():
    # SURVEY section 7: n = 126869, m = 10100, r = 74384 -> 935906717.
    pub = pt.PaillierPublicKey(126869)
    batch = pt.EncryptedBatch.encrypt(
        pub, [pt.EncodedNumber(pub, 10100, 0)], precision=1,
        r_values=[74384], device="cpu")
    assert batch.ciphertext_ints(be_secure=False) == [935906717]


def test_round_trip_at_the_2048_bit_geometry():
    pub = pt.PaillierPublicKey(_P * _Q)
    priv = pt.PaillierPrivateKey(pub, _P, _Q)
    values = [-4.25e5, 987654.125]
    rs = _pinned(pub, 2, 54)
    batch = pt.EncryptedBatch.encrypt(pub, values, r_values=rs, device="cpu")
    assert batch.mont.shape == (4, 296)
    encs = pt.EncodedNumber.encode_many(pub, values)
    assert batch.ciphertext_ints(be_secure=False) == [
        pub.raw_encrypt(e.encoding, r_value=r) for e, r in zip(encs, rs)]
    assert batch.decrypt(priv) == values
