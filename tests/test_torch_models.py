"""Short obfuscation and the two applications of the port against phe_tpu.

On the CPU, at 256-bit keys (one small batch at the 2048-bit geometry),
phe_tpu runs its RNS engine with the XLA ladder and phe_tpu_torch its
plain PyTorch versions; inputs come from seeded numpy generators. Short
obfuscation with h and the exponents pinned equals Python's pow; the
unblinded encryption equals phe_tpu's nude rows; encrypted logistic
scores and federated aggregates equal phe_tpu's, ciphertext for
ciphertext where r is pinned. Tolerance zero throughout: all exact
integer arithmetic, and decrypted floats are the exactly rounded results.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import phe_tpu
from phe_tpu import batch as jbatch
from phe_tpu.models import federated as jfed
from phe_tpu.models import logreg as jlog
from phe_tpu.parallel import batch_mesh as j_batch_mesh

import phe_tpu_torch as pt
from phe_tpu_torch import batch as tbatch
from phe_tpu_torch import interop, parallel
from phe_tpu_torch.models import federated as tfed
from phe_tpu_torch.models import logreg as tlog
from phe_tpu_torch.ops import montgomery as mg
from phe_tpu_torch.utils import limbs as hl
from __graft_entry__ import _P, _Q

CPU = torch.device("cpu")
VALUES = [1.5, -2.0, 300.0, 0.0625, 7, -1e-3, 12345.678]


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


# -- short obfuscation --------------------------------------------------------


def test_short_obfuscators_equal_python_pow(keys):
    jpub, jpriv, pub, priv = keys
    dc = pub.device_context(CPU)
    nsq = pub.nsquare
    rng = np.random.default_rng(71)
    x = 1 + int.from_bytes(rng.bytes(40), "little") % (pub.n - 1)
    xm = mg.to_mont(mg._tensor(hl.ints_to_limbs([x], dc.L), CPU), dc.ctx)
    h = tbatch._short_base_dev(xm, dc.n_digits, dc.ctx)
    h_int = dc.export_ints(h)[0]
    assert h_int == pow(x, pub.n, nsq)
    encs = pt.EncodedNumber.encode_many(pub, VALUES)
    nude = dc.nude_encrypt([e.encoding for e in encs])
    a = [int.from_bytes(rng.bytes(40), "little") for _ in range(nude.shape[0])]
    a[1], a[2] = 0, 1
    digits = tbatch._digits_rows(a, tbatch.SHORT_EXPONENT_BITS)
    assert digits.shape == (8, 80) and digits.dtype == np.int8
    obf = tbatch._obfuscate_short_dev(nude, h, digits, dc.ctx)
    assert dc.export_ints(obf) == [
        c * pow(h_int, ai, nsq) % nsq
        for c, ai in zip(dc.export_ints(nude), a)]


def test_short_obfuscation_decrypts_and_blinds(keys):
    jpub, jpriv, pub, priv = keys
    fresh = pt.EncryptedBatch.encrypt(pub, VALUES, obfuscation="short",
                                      device=CPU)
    nude = pt.EncryptedBatch.encrypt(pub, VALUES, obfuscation="none",
                                     device=CPU)
    assert fresh.is_obfuscated and not nude.is_obfuscated
    assert fresh.decrypt(priv) == nude.decrypt(priv) == VALUES
    raw = nude.ciphertext_ints(be_secure=False)
    blinded = fresh.ciphertext_ints(be_secure=False)
    assert all(b != r for b, r in zip(blinded, raw))
    again = nude.obfuscate(mode="short")
    assert again.is_obfuscated and again.decrypt(priv) == VALUES
    assert again.ciphertext_ints(be_secure=False) != blinded
    # h is drawn once per key and device, and reused.
    dc = pub.device_context(CPU)
    h = dc._h_mont
    pt.EncryptedBatch.encrypt(pub, VALUES[:2], obfuscation="short",
                              device=CPU)
    assert dc._h_mont is h


def test_unblinded_encrypt_equals_phe_tpu_nude_rows(keys):
    jpub, jpriv, pub, priv = keys
    got = pt.EncryptedBatch.encrypt(pub, VALUES, obfuscation="none",
                                    device=CPU)
    jdc = jpub.device_context()
    encs = [e.encoding for e in phe_tpu.EncodedNumber.encode_many(jpub,
                                                                  VALUES)]
    want = jdc.export_ints(jdc.nude_encrypt(encs))[: len(VALUES)]
    assert got.ciphertext_ints(be_secure=False) == want == [
        (1 + pub.n * m) % pub.nsquare for m in encs]
    ref = jbatch.EncryptedBatch.encrypt(jpub, VALUES, obfuscation="none")
    assert ref.ciphertext_ints(be_secure=False) == want


def test_scalar_multiply_at_the_2048_bit_geometry():
    pub = pt.PaillierPublicKey(_P * _Q)
    priv = pt.PaillierPrivateKey(pub, _P, _Q)
    values = [-4.25e5, 987654.125]
    rs = _pinned(pub, 2, 72)
    batch = pt.EncryptedBatch.encrypt(pub, values, r_values=rs, device=CPU)
    nsq = pub.nsquare
    cts = batch.ciphertext_ints(be_secure=False)
    got = batch * [3, -2]
    assert got.ciphertext_ints(be_secure=False) == [
        pow(cts[0], 3, nsq), pow(cts[1], -2, nsq)]
    assert got.decrypt(priv) == [-1.275e6, -1975308.25]
    assert (batch + got).decrypt(priv) == [-1.7e6, -987654.125]


# -- encrypted logistic-regression scoring --------------------------------------


def _as_dict(x):
    if hasattr(x, "_fields"):
        return {f: _as_dict(getattr(x, f)) for f in x._fields}
    return np.asarray(x)


def test_encrypted_scores_equal_phe_tpu(keys):
    jpub, jpriv, pub, priv = keys
    rng = np.random.default_rng(73)
    coef = rng.normal(size=5).round(6)
    intercept = -0.375
    X = rng.normal(size=(6, 5)).round(4)
    weights = [float(w) for w in coef] + [intercept]
    rs = _pinned(pub, len(weights), 74)
    jw = jbatch.EncryptedBatch.encrypt(jpub, weights, r_values=rs)
    jscorer = jlog.EncryptedScorer(jpub, jw)
    # Alice's encrypted weights carried across as phe_tpu's limb rows.
    scorer = tlog.EncryptedScorer(pub, interop.batch_from_limbs(
        pub, np.asarray(jw.mont), jw.exponents, device=CPU))
    got, ref = scorer.encrypted_scores(X), jscorer.encrypted_scores(X)
    assert got.ciphertext_ints(be_secure=False) == ref.ciphertext_ints(
        be_secure=False)
    scores = got.decrypt(priv)
    Xf = np.hstack([X, np.ones((6, 1))])
    assert scores == ref.decrypt(jpriv) == [
        float(sum(Fraction(x) * Fraction(w) for x, w in zip(row, weights)))
        for row in Xf.tolist()]
    np.testing.assert_array_equal(
        tlog.score_roundtrip(priv, scorer, X),
        jlog.score_roundtrip(jpriv, jscorer, X))
    mine = tlog.EncryptedScorer.from_model(pub, coef, intercept, device=CPU)
    assert mine.encrypted_scores(X).decrypt(priv) == scores


def test_scorer_from_a_trained_model(keys):
    jpub, jpriv, pub, priv = keys
    model, X_test, _ = tlog.train_spam_classifier(n_samples=120,
                                                  n_features=6)
    jmodel, jX, _ = jlog.train_spam_classifier(n_samples=120, n_features=6)
    np.testing.assert_array_equal(X_test, jX)
    scorer = tlog.EncryptedScorer.from_model(pub, model.coef_,
                                             model.intercept_[0], device=CPU)
    probs = tlog.score_roundtrip(priv, scorer, X_test[:4])
    jscorer = jlog.EncryptedScorer.from_model(jpub, jmodel.coef_,
                                              jmodel.intercept_[0])
    np.testing.assert_array_equal(
        probs, jlog.score_roundtrip(jpriv, jscorer, jX[:4]))


# -- federated aggregation ------------------------------------------------------


def test_aggregate_equals_phe_tpu(keys):
    jpub, jpriv, pub, priv = keys
    rng = np.random.default_rng(75)
    # Per-client magnitudes differ, so the exponents align.
    grads = rng.normal(size=(3, 6)) * np.array([[1.0], [1e-4], [1e5]])
    mine, theirs = [], []
    for i, g in enumerate(grads):
        vals = [float(v) for v in g]
        rs = _pinned(pub, len(vals), 76 + i)
        mine.append(pt.EncryptedBatch.encrypt(pub, vals, r_values=rs,
                                              device=CPU))
        theirs.append(jbatch.EncryptedBatch.encrypt(jpub, vals, r_values=rs))
    got = tfed.aggregate_encrypted_gradients(mine)
    ref = jfed.aggregate_encrypted_gradients(theirs)
    assert list(got.exponents) == list(ref.exponents)
    assert got.ciphertext_ints(be_secure=False) == ref.ciphertext_ints(
        be_secure=False)
    assert got.decrypt(priv) == ref.decrypt(jpriv) == [
        float(sum(Fraction(v) for v in col)) for col in grads.T.tolist()]
    # Over a mesh (a world of one here; phe_tpu's over its 8 CPU devices)
    # the sum is the same, ciphertext for ciphertext.
    meshed = tfed.aggregate_encrypted_gradients(mine,
                                                mesh=parallel.batch_mesh())
    jmeshed = jfed.aggregate_encrypted_gradients(theirs,
                                                 mesh=j_batch_mesh())
    assert meshed.ciphertext_ints(False) == got.ciphertext_ints(False) \
        == jmeshed.ciphertext_ints(False)
    assert list(meshed.exponents) == list(jmeshed.exponents)


def test_federated_run_matches_phe_tpu():
    rng = np.random.default_rng(0)
    w_true = np.array([1.0, -2.0, 0.5])
    X = rng.normal(size=(60, 3))
    y = X @ w_true + 0.01 * rng.normal(size=60)
    data = (np.array_split(X[:45], 3), np.array_split(y[:45], 3),
            X[45:], y[45:])
    got = tfed.run_federated_learning(n_clients=3, n_iter=3, eta=1.0,
                                      key_length=256, data=data, device=CPU)
    ref = jfed.run_federated_learning(n_clients=3, n_iter=3, eta=1.0,
                                      key_length=256, data=data)
    assert got["mse"] == ref["mse"]
    np.testing.assert_array_equal(got["weights"], ref["weights"])
    assert got["mse"][-1] < got["mse"][0]


def test_examples_run_on_the_cpu(capsys):
    """The port's three examples (python -m phe_tpu_torch.examples.<name>)
    at small sizes, with --device cpu."""
    from phe_tpu_torch.examples import (
        alternative_base,
        federated_learning,
        logistic_regression,
    )

    alternative_base.main(["--device", "cpu"])
    result = federated_learning.main(
        ["--clients", "2", "--iters", "2", "--key-length", "256", "--mesh",
         "--device", "cpu"])
    assert len(result["mse"]) == 2 and result["mse"][-1] < result["mse"][0]
    acc, agrees = logistic_regression.main(
        ["--key-length", "256", "--examples", "8", "--device", "cpu"])
    assert agrees and 0.0 <= acc <= 1.0
    out = capsys.readouterr().out
    assert "batch roundtrip OK" in out and "MSE trajectory" in out
