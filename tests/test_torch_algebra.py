"""The port's homomorphic algebra on EncryptedBatch against phe_tpu.

On the CPU, at 256-bit keys, phe_tpu runs its RNS engine with the XLA
ladder (PHE_TPU_ENGINE=rns, PHE_TPU_RNS_KERNEL=xla, as
tests/test_engine_rns.py sets them) and phe_tpu_torch its plain PyTorch
versions. Batches are built with pinned r in both packages, and every
operation's ciphertext ints (be_secure=False) are equal, as are the
decrypted values, which also equal the exactly rounded results where the
encoding keeps them exact. Tolerance zero throughout: all exact integer
arithmetic. The host helpers of the scalar-multiply prologue are
array-equal to phe_tpu's.
"""

import numpy as np
import pytest
import torch

import phe_tpu
from phe_tpu import batch as jbatch

import phe_tpu_torch as pt
from phe_tpu_torch import batch as tbatch
from phe_tpu_torch import interop
from phe_tpu_torch.ops import montgomery as mg

CPU = torch.device("cpu")

A = [1.5, -2.0, 300.0, 0.0625, 7, -1e-3, 12345.678]
B = [2.5e-3, 7.0, -1.0, 4.0, -3.25, 1e6, 0.5]
INTS = [3, -7, 1000, 42, 0, -1, 1 << 40]


@pytest.fixture(autouse=True)
def _force_rns(monkeypatch):
    monkeypatch.setenv("PHE_TPU_ENGINE", "rns")
    monkeypatch.setenv("PHE_TPU_RNS_KERNEL", "xla")


@pytest.fixture(scope="module")
def keys():
    jpub, jpriv = phe_tpu.generate_paillier_keypair(n_length=256)
    pub = pt.PaillierPublicKey(jpub.n)
    return jpub, jpriv, pub, pt.PaillierPrivateKey(pub, jpriv.p, jpriv.q)


def _pinned(pub, count, seed):
    rng = np.random.default_rng(seed)
    return [1 + int.from_bytes(rng.bytes(pub.n.bit_length() // 8 + 8),
                               "little") % (pub.n - 1) for _ in range(count)]


def _pair(keys, values, seed):
    """(port batch, phe_tpu batch) of the same values under the same r."""
    jpub, _, pub, _ = keys
    rs = _pinned(pub, len(values), seed)
    return (pt.EncryptedBatch.encrypt(pub, values, r_values=rs, device=CPU),
            jbatch.EncryptedBatch.encrypt(jpub, values, r_values=rs))


MATRIX = np.array([[1.0, -2.0, 0.5, 3.0, 1.0, -0.75, 2.0],
                   [-1.5, 4.0, -0.25, 2.0, 0.5, 8.0, -3.0],
                   [0.0, 1e-3, -7.0, 1.0, -1.0, 2.5, 0.125]])


def _cases():
    """name -> (operation on a batch pair, expected decrypted values)."""
    from fractions import Fraction

    s_float = [3.0, -0.5, 2.0, -16.0, 1.25, 1e3, -7.5]
    s_int = [3, -2, 0, 5, -1, 7, 2]
    s_add = [0.5, -4.0, 1e-2, 7, -3.25, 12.5, 100.0]

    def rows_dot(row, vals):
        return float(sum(Fraction(x) * Fraction(w) for x, w in zip(row, vals)))

    return {
        "add_equal_exponents": (
            lambda a, b, a2: a + a2, [x + x for x in A]),
        "add_aligned": (lambda a, b, a2: a + b,
                        [x + y for x, y in zip(A, B)]),
        "add_scalars_aligned": (lambda a, b, a2: a + s_add,
                                [x + y for x, y in zip(A, s_add)]),
        "sub_encrypted": (lambda a, b, a2: a - b,
                          [x - y for x, y in zip(A, B)]),
        "sub_scalars": (lambda a, b, a2: a - s_add,
                        [x - y for x, y in zip(A, s_add)]),
        "mul_mixed_floats": (lambda a, b, a2: a * s_float,
                             [x * y for x, y in zip(A, s_float)]),
        "mul_positive_floats": (lambda a, b, a2: a * [abs(v) for v in s_float],
                                [x * abs(y) for x, y in zip(A, s_float)]),
        "mul_mixed_ints": (lambda a, b, a2: a * s_int,
                           [x * y for x, y in zip(A, s_int)]),
        "mul_negative_scalar": (lambda a, b, a2: -3 * a, [-3 * x for x in A]),
        "decrease_exponent_to": (
            lambda a, b, a2: a.decrease_exponent_to(a.exponents.min() - 2),
            [float(x) for x in A]),
        "sum_mixed_exponents": (lambda a, b, a2: a.sum(),
                                [float(sum(Fraction(x) for x in A))]),
        "dot": (lambda a, b, a2: a.dot(s_float),
                [rows_dot(s_float, A)]),
        "matvec_mixed_signs": (lambda a, b, a2: a.matvec(MATRIX),
                               [rows_dot(row, A) for row in MATRIX.tolist()]),
        "matvec_non_negative": (
            lambda a, b, a2: b.matvec(np.abs(MATRIX)),
            [rows_dot(row, B) for row in np.abs(MATRIX).tolist()]),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_algebra_ciphertexts_equal_phe_tpu(keys, name):
    jpub, jpriv, pub, priv = keys
    op, want = _cases()[name]
    a, ja = _pair(keys, A, 61)
    b, jb = _pair(keys, B, 62)
    a2, ja2 = _pair(keys, A, 63)
    got, ref = op(a, b, a2), op(ja, jb, ja2)
    assert list(got.exponents) == list(ref.exponents)
    assert got.ciphertext_ints(be_secure=False) == ref.ciphertext_ints(
        be_secure=False)
    out = got.decrypt(priv)
    assert out == ref.decrypt(jpriv) == want


@pytest.mark.parametrize("which", ["add_scalars", "sum"])
def test_equal_exponent_paths_at_ints(keys, which):
    """add_scalars and sum at equal exponents (no alignment ladder)."""
    jpub, jpriv, pub, priv = keys
    a, ja = _pair(keys, INTS, 64)
    if which == "sum":
        got, ref, want = a.sum(), ja.sum(), [sum(INTS)]
    else:
        s = [5, -3, 1, 0, 9, 2, -(1 << 30)]
        got, ref, want = a + s, ja + s, [x + y for x, y in zip(INTS, s)]
    assert list(got.exponents) == list(ref.exponents) == [0] * len(want)
    assert got.ciphertext_ints(be_secure=False) == ref.ciphertext_ints(
        be_secure=False)
    assert got.decrypt(priv) == ref.decrypt(jpriv) == want


def test_inverse_mont_chunked_against_single_chunk(keys, monkeypatch):
    jpub, jpriv, pub, priv = keys
    values = [float(v) for v in range(1, 11)]
    rs = _pinned(pub, len(values), 65)
    single = pt.EncryptedBatch.encrypt(pub, values, r_values=rs, device=CPU)
    chunked = pt.EncryptedBatch.encrypt(pub, values, r_values=rs, device=CPU)
    monkeypatch.setattr(pt.EncryptedBatch, "_INVERSE_CHUNK", 4)
    assert chunked.mont.shape[0] == 16  # four chunks of four
    inv_chunked = chunked.inverse_mont()
    monkeypatch.setattr(pt.EncryptedBatch, "_INVERSE_CHUNK", 1 << 20)
    inv_single = single.inverse_mont()
    dc = single._dc
    nsq = pub.nsquare
    cts = single.ciphertext_ints(be_secure=False)
    want = [pow(c, -1, nsq) for c in cts]
    assert dc.export_ints(inv_chunked)[:10] == want
    assert dc.export_ints(inv_single)[:10] == want
    assert single.inverse_mont() is inv_single  # cached
    scal = [(-1.0) ** i * (i + 0.5) for i in range(10)]
    assert (chunked * scal).decrypt(priv) == [
        a * b for a, b in zip(values, scal)]
    single.ciphertext_ints()  # secure export replaces mont: cache resets
    assert single._inv_mont is None


def test_digits_rows_array_equal():
    rng = np.random.default_rng(66)
    floats = [float(v) for v in rng.uniform(-1e6, 1e6, 9)] + [0.0, 2.0**-1074]
    cases = [
        (np.array([0, 1, 5, (1 << 62) + 3, (1 << 63) - 1], np.int64), 63, 4),
        ([0, 1, 1 << 63, (1 << 64) - 1], 64, 4),
        ([int(v) for v in rng.integers(0, 1 << 53, 7)], 53, 5),
        ([int.from_bytes(rng.bytes(40), "little") for _ in range(6)] + [0, 1],
         320, 4),
        ([16 ** 40, 1, 16 ** 3], 161, 4),
        ([3, 200], 8, 8),
    ]
    for exps, bits, window in cases:
        for pad in (None, 12):
            got = tbatch._digits_rows(exps, bits, window, pad_rows=pad)
            want = np.asarray(jbatch._digits_rows(exps, bits, window,
                                                  pad_rows=pad))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    pub = phe_tpu.generate_paillier_keypair(n_length=256)[0]
    tpub = pt.PaillierPublicKey(pub.n)
    for scalars in (floats, [3, -7, 0, 1 << 62, -(1 << 62), True],
                    [np.iinfo(np.int64).min + 1, np.iinfo(np.int64).max]):
        got = tbatch._signed_mantissas_fast(tpub, scalars)
        want = jbatch._signed_mantissas_fast(pub, scalars)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for scalars in ([np.iinfo(np.int64).min], [1 << 64], [float("nan")],
                    [1, 2.5]):
        assert tbatch._signed_mantissas_fast(tpub, scalars) is None
        assert jbatch._signed_mantissas_fast(pub, scalars) is None


def test_signed_mantissas_compare_integers_at_small_keys():
    """max_int between 2^53 and 2^57: the mantissa float(max_int) > max_int
    passes phe_tpu's float compare (float(max_int) rounds up) but not the
    port's integer compare, which leaves it to encode_many's error."""
    n = 3 * (1 << 55) + 19  # max_int = n // 3 - 1 = 2^55 + 5
    pub = pt.PaillierPublicKey(n)
    over = float(pub.max_int)  # rounds up to 2^55 + 8
    assert over > pub.max_int and int(over) == (1 << 55) + 8
    jpub = phe_tpu.PaillierPublicKey(n)
    assert jbatch._signed_mantissas_fast(jpub, [over]) is not None
    assert tbatch._signed_mantissas_fast(pub, [over]) is None
    ok = tbatch._signed_mantissas_fast(pub, [float(1 << 55), -3.0])
    np.testing.assert_array_equal(ok[0], [1 << 55, 3 << 52])
    np.testing.assert_array_equal(ok[1], [0, 1])
    np.testing.assert_array_equal(ok[2], [0, -13])
    with pytest.raises(ValueError, match="exceeds"):
        pt.EncodedNumber.encode_many(pub, [over])


def test_rns_pub_state_builder_array_equal(keys):
    jpub, jpriv, pub, priv = keys
    jst = jpub.device_context().rns_state()

    def as_dict(x):
        if hasattr(x, "_fields"):
            return {f: as_dict(getattr(x, f)) for f in x._fields}
        return np.asarray(x)

    got = pub.device_context(CPU).rns_state()
    want = interop.rns_pub_state(as_dict(jst), CPU)
    for f in ("entry_mont", "exit_r"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for part in ("rsys", "conv", "red"):
        g, w = getattr(got, part), getattr(want, part)
        for f in g._fields:
            a, b = getattr(g, f), getattr(w, f)
            assert torch.equal(a, b) if torch.is_tensor(a) else a == b, f
    # The state carried across drives the port's per-element modexp to the
    # same ciphertexts.
    a, ja = _pair(keys, A, 67)
    digits = tbatch._digits_rows([16 ** 3] * len(A), 13, pad_rows=8)
    mine = tbatch._pow_elems(a.mont, digits, a._dc.ctx, got)
    carried = tbatch._pow_elems(a.mont, digits, a._dc.ctx, want)
    assert torch.equal(mine, carried)
    assert a._dc.export_ints(mine)[:len(A)] == [
        pow(c, 16 ** 3, pub.nsquare) for c in a.ciphertext_ints(False)]


def test_encrypted_numbers_round_trip(keys):
    jpub, jpriv, pub, priv = keys
    a, _ = _pair(keys, A, 68)
    numbers = a.to_encrypted_numbers(be_secure=False)
    assert [priv.decrypt(x) for x in numbers] == A
    back = pt.EncryptedBatch.from_encrypted_numbers(numbers, device=CPU)
    assert back.ciphertext_ints(be_secure=False) == a.ciphertext_ints(False)
    assert torch.equal(a.mont_logical, a.mont[: len(A)])
    with pytest.raises(ValueError, match="empty"):
        pt.EncryptedBatch.from_encrypted_numbers([])


def test_algebra_errors(keys):
    jpub, jpriv, pub, priv = keys
    a, _ = _pair(keys, A, 69)
    other = pt.EncryptedBatch.encrypt(pt.generate_paillier_keypair(
        n_length=128)[0], A, device=CPU)
    with pytest.raises(ValueError, match="different public keys"):
        a + other
    with pytest.raises(ValueError, match="size mismatch"):
        a + pt.EncryptedBatch.encrypt(pub, A[:3], device=CPU)
    with pytest.raises(ValueError, match="length mismatch"):
        a * [1, 2]
    with pytest.raises(ValueError, match="more negative"):
        a.decrease_exponent_to(a.exponents + 1)
    with pytest.raises(ValueError, match="matrix"):
        a.matvec(np.ones((2, 3)))
    with pytest.raises(ValueError, match="obfuscation mode"):
        pt.EncryptedBatch.encrypt(pub, A, obfuscation="fast", device=CPU)
    with pytest.raises(ValueError, match="obfuscation mode"):
        a.obfuscate("fast")
    assert a.decrease_exponent_to(a.exponents) is a
    assert mg.DEFAULT_WINDOW == tbatch.DEFAULT_WINDOW == 4
