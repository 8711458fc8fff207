"""The plain reference against direct Python-integer computations."""

import fractions
import random

import numpy as np

from paillier_bench.protocols import fl_aggregate, rng
from paillier_bench.reference import paillier as ref
from paillier_bench.tests.conftest import P, Q, _load

KEY = ref.Key(int(P, 16), int(Q, 16))


def _encrypt(m, r):
    """Paillier encryption with Python integers: (1 + n m) r^n mod n^2."""
    n, nsq = KEY.n, KEY.nsquare
    return (1 + n * KEY.residue(m)) * pow(r, n, nsq) % nsq


def _floats(rng, count):
    scale = 10.0 ** rng.integers(-12, 12, count)
    return rng.normal(0, 1, count) * scale


def test_encode_array_is_python_paillier_encode():
    values = _floats(np.random.default_rng(1), 4000)
    values = np.concatenate([values, [0.0, -0.0, 1.0, -1.0, 0.5, 2.0**-60]])
    mant, exps = ref.encode_array(values)
    for x, m, e in zip(values.tolist(), mant.tolist(), exps.tolist()):
        assert ref.encode(x) == (m, e)
        assert ref.decode(m, e) == x


def test_encode_is_exact_rational_scaling():
    for x in (0.1, -3.75, 1e-300, 12345.678):
        m, e = ref.encode(x)
        assert fractions.Fraction(m) * fractions.Fraction(16) ** e == \
            fractions.Fraction(x)


def test_decrypt_and_blinding_against_python_ints():
    r = random.Random(5)
    for m in (0, 1, -1, 2**100, -(2**120), KEY.max_int, -KEY.max_int):
        c = _encrypt(m, r.randrange(2, KEY.n))
        assert KEY.signed(KEY.decrypt(c)) == m
        assert KEY.blinded(c)
        assert not KEY.blinded(_encrypt(m, 1))


def test_fl_reference_against_python_int_aggregation():
    """Each client's encodings encrypted, aligned and multiplied with
    Python ints decrypt to aligned_sum's residue, whose value is the
    rational sum of the clients' floats."""
    rng = np.random.default_rng(3)
    r = random.Random(3)
    g = rng.normal(0, 0.01, (5, 16))
    mant, exps = ref.encode_array(g)
    for j in range(g.shape[1]):
        total, target = ref.aligned_sum(mant[:, j], exps[:, j])
        c = 1
        for k in range(g.shape[0]):
            ct = _encrypt(int(mant[k, j]), r.randrange(2, KEY.n))
            c = c * pow(ct, 16 ** int(exps[k, j] - target), KEY.nsquare)
        c %= KEY.nsquare
        assert KEY.decrypt(c) == KEY.residue(total)
        exact = sum(fractions.Fraction(x) for x in g[:, j].tolist())
        assert fractions.Fraction(total) * fractions.Fraction(16) ** \
            target == exact
        assert ref.decode(total, target) == float(exact)


class _Tracer:
    def span(self, name):
        import contextlib

        return contextlib.nullcontext()


def _config():
    return dict(_load("configs", "fedavg_2nn-2048.json"), p=P, q=Q)


def test_generators_repeat_from_the_seed():
    traffic = _load("traffic", "fl_fedavg_2nn.json")
    a = fl_aggregate.Mix(_config(), traffic, 2**31 + 3, "cpu", _Tracer())
    b = fl_aggregate.Mix(_config(), traffic, 2**31 + 3, "cpu", _Tracer())
    c = fl_aggregate.Mix(_config(), traffic, 2**31 + 4, "cpu", _Tracer())
    assert np.array_equal(a.values(7), b.values(7))
    assert not np.array_equal(a.values(7), c.values(7))
    assert a.values(12).shape == (10, 2602)
    assert a.values(13).shape == (10, 16384)
    # Every magnitude as drawn: the values are the seed's normal draws.
    assert np.array_equal(a.values(14), rng(2**31 + 3, 0, 1, 1).normal(
        0.0, 0.01, (10, 16384)))


def test_aligned_sums_are_aligned_sum_by_column():
    rng_ = np.random.default_rng(8)
    g = _floats(rng_, 40 * 7).reshape(7, 40)
    mant, exps = ref.encode_array(g)
    assert ref.aligned_sums(mant, exps) == [
        ref.aligned_sum(mant[:, j], exps[:, j])[0] for j in range(40)]
