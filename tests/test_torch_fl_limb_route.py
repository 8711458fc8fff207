"""The 8192-bit key's route through the FL round, at a size the CPU runs.

A key whose n^2 lies past ``rns.fits`` runs every modexp mod n^2 on the
limb engine (r^n, alignment) while its decrypt halves p^2, q^2 stay on
the RNS ladder. At 8,192 bits that is
the benchmark's ``fl_2nn-8192`` cell. Here ``rns.fits`` is made to refuse
moduli above 300 bits, so that a 256-bit key takes the same route: n^2
(512 bits) on the limb engine, p^2 and q^2 (256 bits) on the ladder.
The round (encrypt per client, ``aggregate_encrypted_gradients``,
decrypt) is held to the benchmark's plain reference, and pinned-r
ciphertexts to the all-RNS route's and to the host's. No phe_tpu here:
the reference is ``paillier_bench.reference.paillier``.
"""

import json
import os

import numpy as np
import pytest
import torch

import phe_tpu_torch as pt
from phe_tpu_torch import batch as tbatch
from phe_tpu_torch.models.federated import aggregate_encrypted_gradients
from phe_tpu_torch.ops import rns
from paillier_bench.protocols import fl_aggregate
from paillier_bench.reference import paillier as ref
from torch_route import refuse_rns

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL_CONFIG = os.path.join(REPO, "paillier_bench", "configs",
                           "fedavg_2nn-8192.json")
FITS_BITS = 300  # the hybrid route's cut-off here: n^2 past it, p^2 under


@pytest.fixture(scope="module")
def primes():
    _, priv = pt.generate_paillier_keypair(n_length=256)
    return priv.p, priv.q


def _keys(p, q):
    """A fresh key pair (no device context cached yet)."""
    pub = pt.PaillierPublicKey(p * q)
    return pub, pt.PaillierPrivateKey(pub, p, q)


@pytest.fixture
def hybrid(monkeypatch):
    """The hybrid route: n^2 past rns.fits, p^2 and q^2 under it."""
    refuse_rns(monkeypatch, FITS_BITS)


def _gradients(seed):
    """[3 clients, 8 coordinates]; column 0 spans magnitudes (exponents
    far apart, so alignment raises by large powers of 16)."""
    g = np.random.default_rng(seed).normal(0.0, 0.01, (3, 8))
    g[:, 0] = [12345.678, -2.5e-7, 3.0]
    return g


def test_round_on_the_hybrid_route_equals_the_reference(primes, hybrid,
                                                        monkeypatch):
    called = []
    for name in ("_encrypt_dev", "_encrypt_rns_dev", "_pow_elems_dev",
                 "_decrypt_compact_dev", "_decrypt_compact_rns_dev"):
        prog = getattr(tbatch, name)

        def spy(*args, _name=name, _prog=prog):
            called.append(_name)
            return _prog(*args)

        monkeypatch.setattr(tbatch, name, spy)
    pub, priv = _keys(*primes)
    g = _gradients(6)
    batches = [pt.EncryptedBatch.encrypt(pub, row.tolist(), device=CPU)
               for row in g]
    aggregate = aggregate_encrypted_gradients(batches)
    got = aggregate.decrypt(priv)
    dc, pdc = pub.device_context(CPU), priv.device_context(CPU)
    assert dc.rns_state() is None and dc.rstate() is None
    halves = pdc.rns_state()
    assert halves is not None and len(halves) == 2
    assert called.count("_encrypt_dev") == 3
    assert "_encrypt_rns_dev" not in called
    assert "_pow_elems_dev" in called  # the alignment ran
    assert called[-1] == "_decrypt_compact_rns_dev"
    mant, exps = ref.encode_array(g)
    totals = ref.aligned_sums(mant, exps)
    want = [ref.decode(t, int(e)) for t, e in zip(totals, exps.min(axis=0))]
    assert got == want
    assert list(aggregate.exponents) == list(exps.min(axis=0))


def test_pinned_ciphertexts_equal_the_all_rns_route_and_the_host(primes,
                                                                 monkeypatch):
    values = _gradients(9)[0].tolist()
    rng = np.random.default_rng(17)
    pub0, _ = _keys(*primes)
    rs = [1 + int.from_bytes(rng.bytes(40), "little") % (pub0.n - 1)
          for _ in values]
    pub, _ = _keys(*primes)
    all_rns = pt.EncryptedBatch.encrypt(pub, values, r_values=rs,
                                        device=CPU)
    assert pub.device_context(CPU).rns_state() is not None
    refuse_rns(monkeypatch, FITS_BITS)
    pub, _ = _keys(*primes)
    limb = pt.EncryptedBatch.encrypt(pub, values, r_values=rs, device=CPU)
    assert pub.device_context(CPU).rns_state() is None
    encodings = pt.EncodedNumber.encode_many(pub, values)
    host = [pub.raw_encrypt(e.encoding, r) for e, r in zip(encodings, rs)]
    assert limb.ciphertext_ints(be_secure=False) == host
    assert all_rns.ciphertext_ints(be_secure=False) == host


def test_cell_config_takes_the_hybrid_route_at_8192_bits():
    with open(CELL_CONFIG) as f:
        config = json.load(f)
    p, q = int(config["p"], 16), int(config["q"], 16)
    n = p * q
    assert config["key_bits"] == n.bit_length() == 8192
    assert not rns.fits(n * n)
    for d in (p, q):
        assert rns.fits(d * d)
        assert rns._channels(d * d)[0] == 624  # build_rns's k
    mix = fl_aggregate.Mix(config, {"gradient_sigma": 0.01}, 1, "cpu", None)
    widths = [mix.width(i) for i in range(mix.calls)]
    assert mix.calls == 390
    assert widths.count(512) == 389 and widths[-1] == 42
    assert tbatch.bucket_rows(widths[-1]) == 64
