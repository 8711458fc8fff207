"""Vertical federated logistic regression on the port against the plain
reference (paillier_bench/reference/hetero_lr.py).

On the CPU at a 255-bit key, 64 rows give sums of about 200 bits, under
max_int (about 2^253). Each step of ``models.hetero_lr.train_step`` is
held to python-paillier's exact encoded arithmetic by equality of the
decoded floats, on seeded data: mixed-sign and zero features (the
inverse base), residuals at different exponents (the alignment fused
into the grid), the transposed matvec with rows far above features, the
masks' round trip, and the spans over the grid's host build. The array
builds of matvec's grid and of add_scalars' encodes are held equal to
the EncodedNumber path they stand in for.
"""

import json

import numpy as np
import pytest
import torch

from paillier_bench.reference import hetero_lr as ref_lr
from paillier_bench.reference import paillier as ref
from phe_tpu_torch import batch as tbatch
from phe_tpu_torch import profiling
from phe_tpu_torch.batch import EncryptedBatch
from phe_tpu_torch.keys import PaillierPrivateKey, PaillierPublicKey
from phe_tpu_torch.models import hetero_lr

# Two fixed 128-bit primes: a 255-bit n, small enough for the CPU.
P = 0x80000000000000000000000001234581
Q = 0xC00000000000000000000000089ABCD1
ROWS = 64


@pytest.fixture(scope="module")
def keys():
    pub = PaillierPublicKey(P * Q)
    return pub, PaillierPrivateKey(pub, P, Q)


def _data(seed, host=3, guest=2, rows=ROWS):
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.0, (rows, host + guest))
    y = np.where(rng.random(rows) < 0.2212, 1.0, -1.0)
    theta = rng.normal(0.0, 0.1, host + guest + 1)
    masks = rng.uniform(-1.0, 1.0, host + guest + 1)
    X_guest = np.hstack([X[:, host:], np.ones((rows, 1))])
    return np.ascontiguousarray(X[:, :host]), X_guest, y, theta, masks


def _step(keys, X_host, X_guest, y, theta, masks):
    pub, priv = keys
    nh = X_host.shape[1]
    args = (theta[:nh], theta[nh:], masks[:nh], masks[nh:])
    got = hetero_lr.train_step(
        hetero_lr.Arbiter(pub, priv), hetero_lr.Host(pub, X_host, "cpu"),
        hetero_lr.Guest(pub, X_guest, y, "cpu"), *args)
    return got, ref_lr.step(X_host, X_guest, y, *args)


def _assert_equal(got, want):
    assert got.plain_host == want.host.masked
    assert got.plain_guest == want.guest.masked
    assert list(got.gradient_host) == list(want.host.gradient)
    assert list(got.gradient_guest) == list(want.guest.gradient)
    assert np.array_equal(got.d.exponents, want.d_exponents)
    assert np.array_equal(got.masked_host.exponents, want.host.exponents)


def test_mixed_sign_and_zero_features_take_the_inverse_base(keys,
                                                            monkeypatch):
    X_host, X_guest, y, theta, masks = _data(11)
    X_host[5, 0], X_host[9, 2], X_guest[3, 1] = 0.0, -0.0, 0.0
    assert (X_host < 0).any() and (X_guest < 0).any()
    inverted = []
    real = EncryptedBatch.inverse_mont

    def spy(self):
        inverted.append(len(self))
        return real(self)

    monkeypatch.setattr(EncryptedBatch, "inverse_mont", spy)
    got, want = _step(keys, X_host, X_guest, y, theta, masks)
    _assert_equal(got, want)
    assert inverted and set(inverted) == {ROWS}


def test_residual_exponents_differ_and_align_inside_the_grid(keys):
    X_host, X_guest, y, theta, masks = _data(12)
    # A residual near zero sits at a lower exponent than the others.
    X_host[0] *= 1e-6
    X_guest[0, :-1] *= 1e-6
    y[0] = 1.0
    theta[-1] = 0.0
    got, want = _step(keys, X_host, X_guest, y, theta, masks)
    _assert_equal(got, want)
    assert len(set(got.d.exponents.tolist())) > 1
    # Products at different exponents: the grid raises each ciphertext
    # by |mantissa| * BASE ** diff, diff > 0 somewhere.
    _, ex = ref.encode_array(X_host)
    exps = want.d_exponents[:, None] + ex
    assert (exps > exps.min(axis=0)).any()


@pytest.mark.parametrize("chunk", [8192, 16])
def test_transposed_matvec_with_rows_far_above_features(keys, monkeypatch,
                                                        chunk):
    """X^T [[v]] for 64 encrypted values against 3 features, with the
    batch inversion in one chunk and in four."""
    pub, priv = keys
    monkeypatch.setattr(EncryptedBatch, "_INVERSE_CHUNK", chunk)
    rng = np.random.default_rng(13)
    v = rng.normal(0.0, 0.3, ROWS)
    X = rng.normal(0.0, 1.0, (ROWS, 3))
    got = EncryptedBatch.encrypt(pub, v.tolist(), device="cpu").matvec(X.T)
    mv, ev = ref.encode_array(v)
    mx, ex = ref.encode_array(X)
    totals = ref.aligned_sums(mv.astype(object)[:, None] * mx,
                              ev[:, None] + ex)
    exps = (ev[:, None] + ex).min(axis=0)
    assert len(got) == 3
    assert np.array_equal(got.exponents, exps)
    assert got.decrypt(priv) == [ref.decode(t, int(e))
                                 for t, e in zip(totals, exps)]


@pytest.mark.parametrize("kind", ["normal", "wide", "ints", "zeros",
                                  "zero_far", "lists"])
def test_grid_built_as_arrays_equals_the_exact_path(keys, monkeypatch,
                                                    kind):
    """matvec's array build of the grid gives the schedules, negative
    mask and row exponents of encode_many and Python ints, also past
    64-bit exponents (wide magnitudes) and for int matrices."""
    pub, _ = keys
    rng = np.random.default_rng(17)
    v = EncryptedBatch(pub, None, ref.encode_array(
        rng.normal(0.0, 0.3, 40))[1])
    M = rng.normal(0.0, 1.0, (3, 40))
    if kind == "wide":
        M *= 10.0 ** rng.integers(-30, 30, M.shape)
    elif kind == "ints":
        M = rng.integers(-(1 << 40), 1 << 40, M.shape)
    elif kind == "zeros":
        M[0, :5], M[1, 3], M[2, 7] = 0.0, -0.0, 0.0
    elif kind == "zero_far":  # zeros far above their rows' least exponent
        M *= 1e-30
        M[:, 3], M[1, 9] = 0.0, -0.0
    elif kind == "lists":  # floats of an object matrix, not a float array
        M = M.astype(object)
    fast = v._grid(M)
    monkeypatch.setattr(tbatch, "_signed_mantissas_fast", lambda *a: None)
    exact = v._grid(M)
    if kind == "wide":
        assert fast[0].shape[-1] > 16  # schedules past 64 bits
    for a, b in zip(fast, exact):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["normal", "tiny", "ints", "zeros"])
def test_add_scalars_as_arrays_equals_the_exact_path(keys, monkeypatch,
                                                     kind):
    """add_scalars' array encode at each element's exponent gives the
    ciphertexts and exponents of EncodedNumber.encode, also where a
    scalar's exponent lies below its element's (the aligned program)."""
    pub, priv = keys
    rng = np.random.default_rng(18)
    batch = EncryptedBatch.encrypt(pub, rng.normal(0.0, 0.3, 12).tolist(),
                                   device="cpu")
    b = rng.normal(0.0, 1.0, 12)
    if kind == "tiny":
        b[::3] *= 1e-30
    elif kind == "ints":
        b = rng.integers(-(1 << 40), 1 << 40, 12)
    elif kind == "zeros":
        b[2], b[5] = 0.0, -0.0
    b = b.tolist()
    fast = batch.add_scalars(b)
    monkeypatch.setattr(tbatch, "_signed_mantissas_fast", lambda *a: None)
    exact = batch.add_scalars(b)
    assert np.array_equal(fast.exponents, exact.exponents)
    assert torch.equal(fast.mont, exact.mont)
    if kind == "tiny":
        assert (fast.exponents < batch.exponents).any()
    assert fast.decrypt(priv) == exact.decrypt(priv)


def test_masks_round_trip(keys):
    """The masked coordinates decrypt to the reference's; the gradient
    without them to its exact sums; unmasking gives the reference's
    gradient."""
    pub, priv = keys
    X_host, X_guest, y, theta, masks = _data(14)
    got, want = _step(keys, X_host, X_guest, y, theta, masks)
    _assert_equal(got, want)
    bare = hetero_lr.Host(pub, X_host, "cpu").encrypted_gradient(got.d)
    mx, ex = ref.encode_array(X_host)
    totals = ref.aligned_sums(want.d_mantissas[:, None] * mx,
                              want.d_exponents[:, None] + ex)
    exps = (want.d_exponents[:, None] + ex).min(axis=0)
    plain = bare.decrypt(priv)
    assert plain == [ref.decode(t, int(e)) for t, e in zip(totals, exps)]
    assert all(m != p for m, p in zip(got.plain_host, plain))
    assert got.gradient_host == pytest.approx(np.asarray(plain) / ROWS,
                                              rel=1e-9, abs=1e-12)


def test_a_step_emits_encode_and_schedule_over_the_grid_build(keys,
                                                              tmp_path):
    """Under profiling.trace() the grid's encodes lie in batch.encode and
    its signed split and schedules in batch.schedule, inside the
    matvec's stretch; no host span holds a program call."""
    pub, priv = keys
    X_host, X_guest, y, theta, masks = _data(15)
    d = EncryptedBatch.encrypt(pub, X_guest[:, 0].tolist(), device="cpu")
    d.inverse_mont()
    with profiling.trace(str(tmp_path)):
        out = d.matvec(X_host.T)
    assert len(out) == 3
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation")
    names = [name for _, _, name in spans]
    assert names[:2] == ["batch.encode", "batch.schedule"]
    assert "program._matvec" in names and set(names) <= profiling.SPANS
    programs_ = [s for s in spans if s[2].startswith("program.")]
    for s, e, name in spans:
        if name in profiling.HOST_SPANS:
            assert not any(s <= a and b <= e for a, b, _ in programs_)


def test_inputs_rounded_to_float32_give_another_answer(keys):
    """The check's float32 control: the step on rounded features and
    theta differs from the reference on the float64 ones."""
    X_host, X_guest, y, theta, masks = _data(16)
    r32 = lambda a: a.astype(np.float32).astype(np.float64)
    got, _ = _step(keys, r32(X_host), r32(X_guest), y, r32(theta), masks)
    want = ref_lr.step(X_host, X_guest, y, theta[:3], theta[3:], masks[:3],
                       masks[3:])
    assert got.plain_host != want.host.masked
    assert torch.is_tensor(got.d.mont)
