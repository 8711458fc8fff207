"""The port's engine configuration (phe_tpu_torch/config.py) against
phe_tpu's (phe_tpu/config.py), on the CPU.

config.current() re-reads PHE_TPU_TORCH_ENGINE, PHE_TPU_TORCH_MXU,
PHE_TPU_TORCH_CACHE_DIR and PHE_TPU_TORCH_NATIVE_DIR on every call; an
engine other than rns, limb or auto raises. The engine picks the program
at phe_tpu's five sites (encrypt_mont, obfuscate_mont, rstate,
raw_decrypt_launch, raw_decrypt_compact), and under limb no RNS state is
built. At a 256-bit key the port under each engine equals phe_tpu under
the same engine (PHE_TPU_ENGINE, with PHE_TPU_BACKEND=xla or
PHE_TPU_RNS_KERNEL=xla): pinned-r ciphertext ints, decrypted values,
compact-decode rows, mul_scalars, decrease_exponent_to, and short
obfuscation decrypting to x. PHE_TPU_TORCH_MXU=0 builds contexts without
REDC matrices, as PHE_TPU_MXU=0 does, with the same public results;
interop carries a phe_tpu context without matrices as one, and a batch
program keys the two kinds of context apart. Tolerance zero: exact
integer arithmetic.
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
from phe_tpu_torch import config, interop, programs
from phe_tpu_torch.ops import cuda_modexp
from phe_tpu_torch.ops import montgomery as mg

CPU = torch.device("cpu")
VARS = ("PHE_TPU_TORCH_ENGINE", "PHE_TPU_TORCH_MXU",
        "PHE_TPU_TORCH_CACHE_DIR", "PHE_TPU_TORCH_NATIVE_DIR")
A = [1.5, -2.0, 300.0, 0.0625, 7, -1e-3, 12345.678]
SCALARS = [3.0, -0.5, 2.0, -16.0, 1.0, -7.25, 1e-3]
# phe_tpu's variables for each engine of the port: its XLA routes.
PHE_TPU_ENV = {
    "limb": {"PHE_TPU_ENGINE": "limb", "PHE_TPU_BACKEND": "xla"},
    "rns": {"PHE_TPU_ENGINE": "rns", "PHE_TPU_RNS_KERNEL": "xla"},
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in VARS:
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
        engine="auto", mxu=True, cache_dir=os.path.join(build, "kernels"),
        native_dir=os.path.join(build, "native"))
    assert config.use_rns_engine() and config.use_mxu()
    assert config.build_dir() == cfg.cache_dir
    assert config.native_dir() == cfg.native_dir
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.engine = "limb"


@pytest.mark.parametrize("var,value,field,want", [
    ("PHE_TPU_TORCH_ENGINE", "rns", "engine", "rns"),
    ("PHE_TPU_TORCH_ENGINE", "limb", "engine", "limb"),
    ("PHE_TPU_TORCH_ENGINE", "auto", "engine", "auto"),
    ("PHE_TPU_TORCH_MXU", "0", "mxu", False),
    ("PHE_TPU_TORCH_MXU", "1", "mxu", True),
    ("PHE_TPU_TORCH_CACHE_DIR", "/x/kernels", "cache_dir", "/x/kernels"),
    ("PHE_TPU_TORCH_NATIVE_DIR", "/x/native", "native_dir", "/x/native"),
])
def test_each_variable_is_read_on_every_call(monkeypatch, var, value, field,
                                             want):
    before = getattr(config.current(), field)
    monkeypatch.setenv(var, value)
    assert getattr(config.current(), field) == want
    assert config.use_rns_engine() == (config.current().engine != "limb")
    assert config.use_mxu() == config.current().mxu
    assert config.build_dir() == config.current().cache_dir
    assert config.native_dir() == config.current().native_dir
    monkeypatch.delenv(var)
    assert getattr(config.current(), field) == before


def test_an_unknown_engine_raises_naming_the_variable(monkeypatch):
    monkeypatch.setenv("PHE_TPU_TORCH_ENGINE", "pallas")
    with pytest.raises(ValueError, match="PHE_TPU_TORCH_ENGINE"):
        config.current()
    with pytest.raises(ValueError, match="PHE_TPU_TORCH_ENGINE"):
        tbatch._use_rns()
    # The build directories read their own variables, not the engine's.
    monkeypatch.setenv("PHE_TPU_TORCH_CACHE_DIR", "/x/kernels")
    assert config.build_dir() == "/x/kernels"
    assert config.native_dir() == config.Config.native_dir


# The _dev programs of each site, RNS first.
SITES = {
    "encrypt_mont": ("_encrypt_rns_dev", "_encrypt_dev"),
    "obfuscate_mont": ("_obfuscate_rns_dev", "_obfuscate_dev"),
    "raw_decrypt_launch": ("_decrypt_rns_dev", "_decrypt_dev"),
    "raw_decrypt_compact": ("_decrypt_compact_rns_dev",
                            "_decrypt_compact_dev"),
}


@pytest.mark.parametrize("engine", ["rns", "limb", "auto"])
def test_engine_routes_the_five_sites(keys, monkeypatch, engine):
    """Which program each site calls under each engine (rstate: what
    _pow_elems_dev is handed), and that under limb neither context ever
    builds its RNS state."""
    monkeypatch.setenv("PHE_TPU_TORCH_ENGINE", engine)
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
    rns = engine != "limb"
    batch = pt.EncryptedBatch.encrypt(pub, A, device=CPU)
    assert called.pop() == (SITES["encrypt_mont"][not rns], None)
    mont = dc.obfuscate_mont(batch.mont)
    assert called.pop() == (SITES["obfuscate_mont"][not rns], None)
    powed = dc.pow_scalars(mont, [3] * len(A), 8)
    name, rstate = called.pop()
    assert name == "_pow_elems_dev" and (rstate is not None) == rns
    assert rstate is dc.rstate()
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
        assert dc._rns is not tbatch._UNBUILT
    else:
        assert built == []
        assert dc._rns is pdc._rns is tbatch._UNBUILT


@pytest.mark.parametrize("engine", ["limb", "rns"])
def test_public_results_equal_phe_tpu_under_each_engine(keys, monkeypatch,
                                                        engine):
    jpub, jpriv, pub, priv = keys
    monkeypatch.setenv("PHE_TPU_TORCH_ENGINE", engine)
    for var, value in PHE_TPU_ENV[engine].items():
        monkeypatch.setenv(var, value)
    rs = _pinned(pub, len(A), 71)
    got = pt.EncryptedBatch.encrypt(pub, A, r_values=rs, device=CPU)
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
    """PHE_TPU_TORCH_MXU=0 against PHE_TPU_MXU=0, both on the limb
    engine: contexts built then have no REDC matrices, and the public
    results equal phe_tpu's; a context built after the variable is unset
    has them again."""
    jpub, jpriv, _, _ = keys
    for var, value in dict(PHE_TPU_ENV["limb"], PHE_TPU_MXU="0",
                           PHE_TPU_TORCH_ENGINE="limb",
                           PHE_TPU_TORCH_MXU="0").items():
        monkeypatch.setenv(var, value)
    pub, priv = _fresh(keys)
    jpub = phe_tpu.PaillierPublicKey(jpub.n)
    jpriv = phe_tpu.PaillierPrivateKey(jpub, jpriv.p, jpriv.q)
    dc, pdc = pub.device_context(CPU), priv.device_context(CPU)
    c = pdc.consts
    for ctx in (dc.ctx, c.ctx_p, c.ctx_q, c.ctx_hp, c.ctx_hq):
        assert not mg.has_matrices(ctx)
        assert cuda_modexp._pow_columns(ctx) is None
    assert jpub.device_context().ctx.w_mq is None
    rs = _pinned(pub, len(A), 72)
    got = pt.EncryptedBatch.encrypt(pub, A, r_values=rs, device=CPU)
    want = jbatch.EncryptedBatch.encrypt(jpub, A, r_values=rs)
    assert got.ciphertext_ints(False) == want.ciphertext_ints(False)
    mine, theirs = got * SCALARS, want * SCALARS
    assert mine.ciphertext_ints(False) == theirs.ciphertext_ints(False)
    assert mine.decrypt(priv) == theirs.decrypt(jpriv) == [
        x * y for x, y in zip(A, SCALARS)]
    monkeypatch.delenv("PHE_TPU_TORCH_MXU")
    assert mg.has_matrices(mg.build_context(pub.nsquare, CPU))
    assert not mg.has_matrices(mg.build_context(pub.nsquare, CPU, mxu=False))


def test_interop_carries_a_context_without_matrices(keys):
    """A phe_tpu context built with mxu=False (w_mq None) arrives without
    REDC matrices; one with them arrives with them; a batch program keys
    two contexts of the same modulus, one of each, apart."""
    jpub = keys[0]
    M = jpub.nsquare
    carried = {}
    for mxu in (False, True):
        jctx = jmg.build_context(M, mxu=mxu)
        d = {f: np.asarray(getattr(jctx, f)) for f in jctx._fields}
        carried[mxu] = ctx = interop.montgomery_context(d, CPU)
        assert mg.has_matrices(ctx) == mxu
        assert (cuda_modexp._pow_columns(ctx) is None) == (not mxu)
    with pytest.raises(ValueError, match="without REDC matrices"):
        mg.redc_matrices(carried[False])
    prog = programs.device_program(mg.mont_mul)
    a = torch.zeros((4, carried[True].num_limbs), dtype=torch.int64)
    key = lambda ctx: prog._key(CPU, prog.signature.bind(a, a, ctx)
                                .arguments)[0]
    assert key(carried[False]) != key(carried[True])
    assert key(carried[False]) == key(carried[False])
