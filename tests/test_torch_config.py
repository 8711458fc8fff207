"""The port's configuration (phe_tpu_torch/config.py) and its engine
route against phe_tpu's (phe_tpu/config.py), on the CPU.

config.current() re-reads PHE_TPU_TORCH_CACHE_DIR and
PHE_TPU_TORCH_NATIVE_DIR on every call, and nothing else: the former
PHE_TPU_TORCH_ENGINE and PHE_TPU_TORCH_MXU, which the benchmark harness
still exports, change neither the route nor the REDC body. The route
follows rns.fits at phe_tpu's five sites (encrypt_mont, obfuscate_mont,
the per-element programs, raw_decrypt_launch, raw_decrypt_compact);
where rns.fits refuses the modulus (made to refuse every one here) no
RNS state is built. At a 256-bit key the port on either route equals
phe_tpu on the same one (PHE_TPU_ENGINE, with PHE_TPU_BACKEND=xla or
PHE_TPU_RNS_KERNEL=xla):
pinned-r ciphertext ints, decrypted values, compact-decode rows,
mul_scalars, decrease_exponent_to, and short obfuscation decrypting to
x; and equals phe_tpu under PHE_TPU_MXU=0, whose contexts carry no REDC
matrices. interop carries a phe_tpu context with or without them as one
that packs the same REDC operands as a fresh port context. Tolerance
zero: exact integer arithmetic.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import phe_tpu
from phe_tpu import batch as jbatch
from phe_tpu.ops import montgomery as jmg

import phe_tpu_torch as pt
from phe_tpu_torch import batch as tbatch
from phe_tpu_torch import config, interop
from phe_tpu_torch.ops import cuda_modexp, cuda_rns
from phe_tpu_torch.ops import montgomery as mg
from torch_route import refuse_rns

CPU = torch.device("cpu")
VARS = ("PHE_TPU_TORCH_CACHE_DIR", "PHE_TPU_TORCH_NATIVE_DIR")
# The variables the port read before the route and the REDC body were
# decided from shape alone; paillier_bench/run.py still exports them.
FORMER_VARS = ("PHE_TPU_TORCH_ENGINE", "PHE_TPU_TORCH_MXU")
A = [1.5, -2.0, 300.0, 0.0625, 7, -1e-3, 12345.678]
SCALARS = [3.0, -0.5, 2.0, -16.0, 1.0, -7.25, 1e-3]
# phe_tpu's variables for each route of the port: its XLA routes.
PHE_TPU_ENV = {
    "limb": {"PHE_TPU_ENGINE": "limb", "PHE_TPU_BACKEND": "xla"},
    "rns": {"PHE_TPU_ENGINE": "rns", "PHE_TPU_RNS_KERNEL": "xla"},
}
H100_SMS = 132  # multiprocessors of an H100 SXM
# The limb kernels' widths on the port's paths, and launch rows around
# the body rule's turns.
PATH_LIMBS = (8, 16, 24, 40, 80, 152, 296, 440, 592, 1176)
PATH_ROWS = (1, 16, 64, 512, 4096, 16384)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in VARS + FORMER_VARS:
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def keys():
    jpub, jpriv = phe_tpu.generate_paillier_keypair(n_length=256)
    pub = pt.PaillierPublicKey(jpub.n)
    return jpub, jpriv, pub, pt.PaillierPrivateKey(pub, jpriv.p, jpriv.q)


def _fresh(keys):
    """New port key objects of the same key (their contexts unbuilt)."""
    _, jpriv, pub, _ = keys
    fresh = pt.PaillierPublicKey(pub.n)
    return fresh, pt.PaillierPrivateKey(fresh, jpriv.p, jpriv.q)


def _pinned(pub, count, seed):
    rng = np.random.default_rng(seed)
    return [1 + int.from_bytes(rng.bytes(pub.n.bit_length() // 8 + 8),
                               "little") % (pub.n - 1) for _ in range(count)]


def test_current_defaults():
    build = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(config.__file__))), "build")
    cfg = config.current()
    assert cfg == config.Config(
        cache_dir=os.path.join(build, "kernels"),
        native_dir=os.path.join(build, "native"))
    assert [f.name for f in dataclasses.fields(cfg)] == ["cache_dir",
                                                         "native_dir"]
    assert config.build_dir() == cfg.cache_dir
    assert config.native_dir() == cfg.native_dir
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.cache_dir = "/x"


@pytest.mark.parametrize("var,value,field,want", [
    ("PHE_TPU_TORCH_CACHE_DIR", "/x/kernels", "cache_dir", "/x/kernels"),
    ("PHE_TPU_TORCH_NATIVE_DIR", "/x/native", "native_dir", "/x/native"),
])
def test_each_variable_is_read_on_every_call(monkeypatch, var, value, field,
                                             want):
    before = getattr(config.current(), field)
    monkeypatch.setenv(var, value)
    assert getattr(config.current(), field) == want
    assert config.build_dir() == config.current().cache_dir
    assert config.native_dir() == config.current().native_dir
    monkeypatch.delenv(var)
    assert getattr(config.current(), field) == before


@pytest.mark.parametrize("var,value", [
    ("PHE_TPU_TORCH_ENGINE", "limb"), ("PHE_TPU_TORCH_ENGINE", "rns"),
    ("PHE_TPU_TORCH_ENGINE", "pallas"), ("PHE_TPU_TORCH_MXU", "0"),
], ids=["ENGINE=limb", "ENGINE=rns", "ENGINE=pallas", "MXU=0"])
def test_the_former_variables_change_nothing(keys, monkeypatch, var, value):
    """With a former variable set, as the harness still sets it from a
    config: config.current() does not raise and reads as without it, both
    contexts of a 256-bit key take the RNS state, and each launch at the
    path widths takes the REDC body it takes with the variable unset."""
    monkeypatch.setattr(cuda_rns, "_sms", lambda device: H100_SMS)
    monkeypatch.setattr(cuda_modexp, "_pow_columns", lambda ctx: (
        torch.zeros(1, dtype=torch.int32),) * 4)
    contexts = {L: mg.build_context((1 << (14 * L - 30)) + 1, CPU)
                for L in PATH_LIMBS}

    def bodies():
        return [cuda_modexp._redc_args(ctx, CPU, L, B)[0]
                for L, ctx in contexts.items() for B in PATH_ROWS]

    unset = bodies()
    assert True in unset and False in unset
    monkeypatch.setenv(var, value)
    assert config.current() == config.Config()
    pub, priv = _fresh(keys)
    dc, pdc = pub.device_context(CPU), priv.device_context(CPU)
    assert dc.rstate() is dc.rns_state() is not None
    assert pdc.rns_state() is not None and len(pdc.rns_state()) == 2
    assert bodies() == unset


# The _dev programs of each site, RNS first.
SITES = {
    "encrypt_mont": ("_encrypt_rns_dev", "_encrypt_dev"),
    "obfuscate_mont": ("_obfuscate_rns_dev", "_obfuscate_dev"),
    "raw_decrypt_launch": ("_decrypt_rns_dev", "_decrypt_dev"),
    "raw_decrypt_compact": ("_decrypt_compact_rns_dev",
                            "_decrypt_compact_dev"),
}


@pytest.mark.parametrize("route", ["fits", "past_fits"])
def test_engine_routes_the_five_sites(keys, monkeypatch, route):
    """Which program each site calls where rns.fits holds and past it
    (rstate: what _pow_elems_dev is handed), and that past it neither
    context ever builds its RNS state."""
    if route == "past_fits":
        refuse_rns(monkeypatch)
    called = []
    for name in [n for pair in SITES.values() for n in pair] + [
            "_pow_elems_dev"]:
        prog = getattr(tbatch, name)

        def spy(*args, _name=name, _prog=prog):
            called.append((_name, args[-1] if _name == "_pow_elems_dev"
                           else None))
            return _prog(*args)

        monkeypatch.setattr(tbatch, name, spy)
    built = []
    for cls, method in ((tbatch.PublicDeviceContext, "_build_rns"),
                        (tbatch.PrivateDeviceContext, "_build_half")):
        real = getattr(cls, method)
        monkeypatch.setattr(cls, method, lambda self, *a, _real=real: (
            built.append(type(self).__name__) or _real(self, *a)))
    pub, priv = _fresh(keys)
    dc, pdc = pub.device_context(CPU), priv.device_context(CPU)
    rns = route == "fits"
    batch = pt.EncryptedBatch.encrypt(pub, A, device=CPU)
    assert called.pop() == (SITES["encrypt_mont"][not rns], None)
    mont = dc.obfuscate_mont(batch.mont)
    assert called.pop() == (SITES["obfuscate_mont"][not rns], None)
    powed = dc.pow_scalars(mont, [3] * len(A), 8)
    name, rstate = called.pop()
    assert name == "_pow_elems_dev" and (rstate is not None) == rns
    assert rstate is dc.rns_state()
    values = pdc.raw_decrypt_batch(mont)
    assert called.pop() == (SITES["raw_decrypt_launch"][not rns], None)
    pdc.raw_decrypt_compact(powed)
    assert called.pop() == (SITES["raw_decrypt_compact"][not rns], None)
    assert not called
    want = [e.encoding for e in pt.EncodedNumber.encode_many(pub, A)]
    assert values[: len(A)] == want
    if rns:
        assert sorted(built) == ["PrivateDeviceContext"] * 2 + [
            "PublicDeviceContext"]
        assert dc._rns is not None
    else:
        assert built == []
        assert dc._rns is pdc._rns is None


@pytest.mark.parametrize("engine", ["limb", "rns"])
def test_public_results_equal_phe_tpu_under_each_engine(keys, monkeypatch,
                                                        engine):
    jpub, jpriv, _, _ = keys
    if engine == "limb":
        refuse_rns(monkeypatch)
    for var, value in PHE_TPU_ENV[engine].items():
        monkeypatch.setenv(var, value)
    pub, priv = _fresh(keys)
    rs = _pinned(pub, len(A), 71)
    got = pt.EncryptedBatch.encrypt(pub, A, r_values=rs, device=CPU)
    assert (pub.device_context(CPU).rns_state() is None) == (engine == "limb")
    want = jbatch.EncryptedBatch.encrypt(jpub, A, r_values=rs)
    assert got.ciphertext_ints(False) == want.ciphertext_ints(False)
    assert got.decrypt(priv) == want.decrypt(jpriv) == A
    compact, full = priv.device_context(CPU).raw_decrypt_compact(got.mont)
    jcompact, jfull = jpriv.device_context().raw_decrypt_compact(want.mont)
    np.testing.assert_array_equal(compact.numpy(),
                                  np.asarray(jcompact).astype(np.int64))
    np.testing.assert_array_equal(full.numpy(), np.asarray(jfull))
    mine, theirs = got * SCALARS, want * SCALARS
    assert mine.ciphertext_ints(False) == theirs.ciphertext_ints(False)
    assert mine.decrypt(priv) == theirs.decrypt(jpriv) == [
        x * y for x, y in zip(A, SCALARS)]
    target = [min(e, -20) for e in got.exponents]
    mine, theirs = (got.decrease_exponent_to(target),
                    want.decrease_exponent_to(target))
    assert list(mine.exponents) == list(theirs.exponents) == target
    assert mine.ciphertext_ints(False) == theirs.ciphertext_ints(False)
    assert mine.decrypt(priv) == A
    short = pt.EncryptedBatch.encrypt(pub, A, obfuscation="short",
                                      device=CPU)
    jshort = jbatch.EncryptedBatch.encrypt(jpub, A, obfuscation="short")
    assert short.decrypt(priv) == jshort.decrypt(jpriv) == A


def test_no_redc_matrices_equals_phe_tpu_without_them(keys, monkeypatch):
    """The port, each launch's REDC body chosen by shape, against phe_tpu
    under PHE_TPU_MXU=0 on its limb route, whose contexts carry no REDC
    matrices: the public results are equal."""
    jpub, jpriv, _, _ = keys
    for var, value in dict(PHE_TPU_ENV["limb"], PHE_TPU_MXU="0").items():
        monkeypatch.setenv(var, value)
    jpub = phe_tpu.PaillierPublicKey(jpub.n)
    jpriv = phe_tpu.PaillierPrivateKey(jpub, jpriv.p, jpriv.q)
    assert jpub.device_context().ctx.w_mq is None
    pub, priv = _fresh(keys)
    rs = _pinned(pub, len(A), 72)
    got = pt.EncryptedBatch.encrypt(pub, A, r_values=rs, device=CPU)
    want = jbatch.EncryptedBatch.encrypt(jpub, A, r_values=rs)
    assert got.ciphertext_ints(False) == want.ciphertext_ints(False)
    mine, theirs = got * SCALARS, want * SCALARS
    assert mine.ciphertext_ints(False) == theirs.ciphertext_ints(False)
    assert mine.decrypt(priv) == theirs.decrypt(jpriv) == [
        x * y for x, y in zip(A, SCALARS)]


@pytest.mark.parametrize("carried", [True, False], ids=["with", "without"])
def test_interop_carries_a_context_without_matrices(keys, carried):
    """A phe_tpu context with REDC matrices (w_mq int8) or without them
    (mxu=False: w_mq None) arrives as a port context that packs the same
    REDC operands (cuda_modexp._pow_columns) as a fresh port context of
    the modulus: the carried matrices where they came, else its own."""
    M = keys[0].nsquare
    jctx = jmg.build_context(M, mxu=carried)
    assert (jctx.w_mq is not None) == carried
    ctx = interop.montgomery_context(
        {f: np.asarray(getattr(jctx, f)) for f in jctx._fields}, CPU)
    assert (mg._carried.get(ctx.m) is not None) == carried
    mine = cuda_modexp._pow_columns(ctx)
    fresh = cuda_modexp._pow_columns(mg.build_context(M, CPU))
    assert len(mine) == len(fresh) == 4
    assert all(torch.equal(a, b) for a, b in zip(mine, fresh))
