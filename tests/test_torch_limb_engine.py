"""The port's limb engine against phe_tpu's limb route.

The limb engine runs the modexps past the RNS channel-prime supply
(rns.fits: n^2 above ~8,760 bits), as phe_tpu does on its chip. On the
CPU, at a 256-bit key, phe_tpu runs its limb route (PHE_TPU_ENGINE=limb,
with PHE_TPU_BACKEND=xla, and pallas in interpret mode for one test) and
the port the plain versions of its limb kernels, with rns.fits made to
refuse every modulus (the ``limb`` fixture). Ciphertext ints, decrypted
residues, compact-decode rows and decoded values are equal: tolerance
zero, all exact integer arithmetic. The supply-boundary tests check
where the supply ends, with the real builders at 8,800 and 8,192 bits.
"""

import numpy as np
import pytest
import torch

import phe_tpu
from phe_tpu import batch as jbatch

import phe_tpu_torch as pt
from phe_tpu_torch import batch as tbatch
from phe_tpu_torch import benchmarks, interop
from phe_tpu_torch.ops import rns
from torch_route import refuse_rns

A = [1.5, -2.0, 300.0, 0.0625, 7, -1e-3, 12345.678]
B = [2.5e-3, 7.0, -1.0, 4.0, -3.25, 1e6, 0.5]
SCALARS = [3.0, -0.5, 2.0, -16.0, 1.0, -7.25, 1e-3]


@pytest.fixture(autouse=True)
def _phe_tpu_limb_route(monkeypatch):
    monkeypatch.setenv("PHE_TPU_ENGINE", "limb")
    monkeypatch.setenv("PHE_TPU_BACKEND", "xla")


@pytest.fixture(scope="module")
def keys():
    jpub, jpriv = phe_tpu.generate_paillier_keypair(n_length=256)
    pub = pt.PaillierPublicKey(jpub.n)
    return jpub, jpriv, pub, pt.PaillierPrivateKey(pub, jpriv.p, jpriv.q)


@pytest.fixture
def limb(keys, monkeypatch):
    """keys with the port on its limb engine: rns.fits refuses every
    modulus, as it refuses n^2 past the supply, and the port's key objects
    are new, so that their contexts are built under it."""
    refuse_rns(monkeypatch)
    jpub, jpriv, pub, _ = keys
    fresh = pt.PaillierPublicKey(pub.n)
    return jpub, jpriv, fresh, pt.PaillierPrivateKey(fresh, jpriv.p,
                                                     jpriv.q)


def _pinned(pub, count, seed):
    rng = np.random.default_rng(seed)
    return [1 + int.from_bytes(rng.bytes(pub.n.bit_length() // 8 + 8),
                               "little") % (pub.n - 1) for _ in range(count)]


def _pair(keys, values, seed):
    """(port batch, phe_tpu batch) of the same values under the same r."""
    jpub, _, pub, _ = keys
    rs = _pinned(pub, len(values), seed)
    return (pt.EncryptedBatch.encrypt(pub, values, r_values=rs, device="cpu"),
            jbatch.EncryptedBatch.encrypt(jpub, values, r_values=rs))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_pinned_encrypt_equal_phe_tpu_limb_route(limb, monkeypatch, backend):
    monkeypatch.setenv("PHE_TPU_BACKEND", backend)
    jpub, _, pub, _ = limb
    got, want = _pair(limb, A, 61)
    assert pub.device_context("cpu").rns_state() is None
    ints = got.ciphertext_ints(be_secure=False)
    assert ints == want.ciphertext_ints(be_secure=False)
    rs = _pinned(pub, len(A), 61)
    assert ints == [pub.raw_encrypt(e.encoding, r_value=r) for e, r in
                    zip(pt.EncodedNumber.encode_many(pub, A), rs)]


def test_reobfuscation_with_pinned_r_equal(limb):
    jpub, _, pub, _ = limb
    got, want = _pair(limb, A, 62)
    rs = _pinned(pub, len(A), 63)
    dc, jdc = pub.device_context("cpu"), jpub.device_context()
    mine = tbatch._obfuscate_limb(got.mont, dc.random_r_bytes(len(A), rs),
                                  dc.n_digits, dc.ctx)
    theirs = jbatch._obfuscate_dev(want.mont, jdc.random_r_bytes(len(A), rs),
                                   jdc.n_digits, jdc.ctx)
    ints = dc.export_ints(mine)[: len(A)]
    assert ints == jdc.export_ints(theirs)[: len(A)]
    nsq = pub.nsquare
    assert ints == [c * pow(r, pub.n, nsq) % nsq for c, r in
                    zip(got.ciphertext_ints(be_secure=False), rs)]


def test_mixed_sign_mul_scalars_equal(limb):
    _, jpriv, _, priv = limb
    got, want = _pair(limb, A, 64)
    mine, theirs = got * SCALARS, want * SCALARS
    assert mine.ciphertext_ints(False) == theirs.ciphertext_ints(False)
    assert mine.decrypt(priv) == theirs.decrypt(jpriv) == [
        x * y for x, y in zip(A, SCALARS)]


def test_aligned_add_and_sum_equal(limb):
    _, jpriv, _, priv = limb
    a, ja = _pair(limb, A, 65)
    b, jb = _pair(limb, B, 66)
    mine, theirs = a + b, ja + jb
    assert mine.ciphertext_ints(False) == theirs.ciphertext_ints(False)
    assert mine.decrypt(priv) == theirs.decrypt(jpriv) == [
        x + y for x, y in zip(A, B)]
    s, js = a.sum(), ja.sum()
    assert s.ciphertext_ints(False) == js.ciphertext_ints(False)
    assert s.decrypt(priv) == js.decrypt(jpriv)


def test_decrypt_residue_limb_and_compact_rows_equal(limb):
    jpub, jpriv, pub, priv = limb
    got, want = _pair(limb, A, 67)
    pdc, jpdc = priv.device_context("cpu"), jpriv.device_context()
    rows = tbatch._decrypt_residue_limb(got.mont, pub.device_context("cpu").ctx,
                                        pdc.consts)
    jrows = jbatch._decrypt_residue_limb(want.mont, jpub.device_context().ctx,
                                         jpdc.consts)
    mine = tbatch._bytes_to_ints(tbatch.lm.pack_bytes(rows))
    assert mine == jbatch._bytes_to_ints(jbatch.lm.pack_bytes(jrows))
    assert mine[: len(A)] == [e.encoding for e in
                              pt.EncodedNumber.encode_many(pub, A)]
    compact, full = pdc.raw_decrypt_compact(got.mont)
    jcompact, jfull = jpdc.raw_decrypt_compact(want.mont)
    np.testing.assert_array_equal(compact.numpy(),
                                  np.asarray(jcompact).astype(np.int64))
    np.testing.assert_array_equal(full.numpy(), np.asarray(jfull))
    assert got.decrypt(priv) == want.decrypt(jpriv) == A


def test_phe_tpu_limb_batch_decrypts_in_the_port(limb):
    jpub, _, pub, priv = limb
    theirs = jbatch.EncryptedBatch.encrypt(jpub, B) * SCALARS
    carried = interop.batch_from_limbs(pub, np.asarray(theirs.mont),
                                       theirs.exponents, device="cpu")
    assert carried.decrypt(priv) == [x * y for x, y in zip(B, SCALARS)]


def test_channels_raise_value_error_past_the_supply():
    modulus = (1 << 8799) + 1
    assert not rns.fits(modulus)
    with pytest.raises(ValueError, match="channel supply"):
        rns._channels(modulus)
    with pytest.raises(ValueError, match="channel supply"):
        rns.build_rns(modulus, "cpu")
    assert rns.fits((1 << 8191) + 1)


def test_8192_bit_key_runs_n_squared_on_the_limb_engine():
    """The fixed 8192-bit key: n^2 (16,384 bits) is past the supply, the
    prime squares (8,192 bits) are not; both answers are cached."""
    pub, priv = benchmarks.fixed_key(8192)
    dc = tbatch.PublicDeviceContext(pub, torch.device("cpu"))
    assert dc.rns_state() is None and dc.rns_state() is None
    assert dc.L == 1176
    pdc = tbatch.PrivateDeviceContext(priv, torch.device("cpu"))
    halves = pdc.rns_state()
    assert len(halves) == 2 and pdc.rns_state() is halves
    assert [h[0].k for h in halves] == [624, 624]
    assert pdc.consts.ctx_p.num_limbs == 592


def test_mont_mul_wrapper_takes_the_8192_bit_geometry(monkeypatch):
    """The Montgomery product's wrapper admits L = 1,176 (n^2 of an
    8192-bit key: 227,072 bytes of shared memory a block of 8 rows of
    the int8 body, above the 48 KB default, which the launch raises; the
    body held by the launch's private argument, since the body rule
    gives 3 rows there to the integer pipe's one-row tile) and refuses a
    context whose block of 8 rows passes the 227 KB a Hopper block can
    have."""
    from phe_tpu_torch.ops import _build, cuda_modexp, cuda_rns
    from phe_tpu_torch.ops import montgomery as mg

    calls = []
    monkeypatch.setattr(cuda_modexp, "_lib", lambda shared, elems, mxu: (
        lambda *args: calls.append((shared, elems) + args) or 0))
    monkeypatch.setattr(_build, "stream_handle", lambda device: None)
    monkeypatch.setattr(cuda_rns, "_sms", lambda device: 132)
    # The clusters of C blocks an H100 holds at once, about.
    monkeypatch.setattr(cuda_modexp, "_fit",
                        lambda kernel, dev, L: lambda C: 120 // C)
    monkeypatch.setitem(cuda_modexp.launches, "mont_mul", 0)
    monkeypatch.setitem(cuda_modexp.launches, "mont_mul_int", 0)
    ctx = mg.build_context((1 << 16383) + 1, "cpu")
    a = torch.zeros((3, 1176), dtype=torch.int64)
    assert cuda_modexp._launch(a, a, ctx, shared=False,
                               body=True).shape == (3, 1176)
    # E = 8 (the only block that fits), one row a block over 3 blocks.
    assert len(calls) == 1 and calls[0][:2] == (False, 8)
    assert calls[0][9:12] == (3, 1, 1176)
    assert cuda_modexp.launches["mont_mul"] == 1
    # Left to the rule: the integer pipe's one-row tile, clusters of 8.
    cuda_modexp._launch(a, a, ctx, shared=False)
    assert calls[1][:2] == (False, 1) and calls[1][7:11] == (3, 1, 8, 1176)
    assert cuda_modexp.launches["mont_mul_int"] == 1
    assert cuda_modexp._pow_smem(1176, 8) == 227072
    wide = mg.build_context((1 << 16800) + 1, "cpu")
    assert wide.num_limbs == 1208 > cuda_modexp.MAX_MUL_LIMBS
    assert cuda_modexp._pow_smem(wide.num_limbs, 8) > cuda_modexp.MAX_SMEM
    b = torch.zeros((1, wide.num_limbs), dtype=torch.int64)
    with pytest.raises(ValueError, match="from 8 to 1200"):
        cuda_modexp._launch(b, b, wide, shared=False)


def _tensors_equal(a, b):
    """Field-by-field equality of two NamedTuples of tensors (nested)."""
    assert type(a) is type(b)
    for x, y in zip(a, b):
        if torch.is_tensor(x):
            assert torch.equal(x, y)
        elif isinstance(x, tuple):
            _tensors_equal(x, y)
        else:
            assert x == y


def test_device_contexts_build_equals_the_constructor(keys, monkeypatch):
    _, _, pub, priv = keys
    cpu = torch.device("cpu")
    dc = tbatch.PublicDeviceContext.build(pub, "cpu")
    ref = tbatch.PublicDeviceContext(pub, cpu)
    assert dc.device == cpu and (dc.L, dc.Ln) == (ref.L, ref.Ln)
    _tensors_equal(dc.ctx, ref.ctx)
    assert torch.equal(dc.n_digits, ref.n_digits)
    assert torch.equal(dc.nr2_limbs, ref.nr2_limbs)
    pdc = tbatch.PrivateDeviceContext.build(priv, "cpu")
    _tensors_equal(pdc.consts, tbatch.PrivateDeviceContext(priv, cpu).consts)
    # The keys construct through build, once per device.
    fresh = pt.PaillierPrivateKey(pt.PaillierPublicKey(pub.n), priv.p,
                                  priv.q)
    calls = []
    real = tbatch.PrivateDeviceContext.build.__func__
    monkeypatch.setattr(tbatch.PrivateDeviceContext, "build", classmethod(
        lambda cls, key, device=None: calls.append(device)
        or real(cls, key, device)))
    assert fresh.device_context("cpu") is fresh.device_context("cpu")
    assert calls == [cpu]
    # No device named: the card, which is not here.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        tbatch.PublicDeviceContext.build(pub)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        tbatch.PrivateDeviceContext.build(priv)


def _crt_powers_pair(jpriv, priv, cts):
    """(port's crt_powers, phe_tpu's) of the same ciphertext ints."""
    pdc = priv.device_context("cpu")
    mine = pdc.crt_powers(pdc.pub_ctx.pack_mod_nsquare(cts))
    jpdc = jbatch.PrivateDeviceContext.build(jpriv)
    theirs = jpdc.crt_powers(jpdc.pub_ctx.pack_mod_nsquare(cts))
    return mine, theirs


def _check_crt_powers(mine, theirs, priv, cts):
    for got, want, d in zip(mine, theirs, (priv.p, priv.q)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))
        ints = tbatch.hl.limbs_to_ints(got.numpy())
        assert ints[: len(cts)] == [pow(c, d - 1, d * d) for c in cts]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_crt_powers_array_equal_to_phe_tpu(keys, monkeypatch, backend):
    """phe_tpu's limb route with its XLA modexp and its Pallas kernel in
    interpret mode; canonical limbs equal, and equal to Python's pow."""
    monkeypatch.setenv("PHE_TPU_BACKEND", backend)
    # The backend is read while tracing: drop the other backend's traces.
    jbatch._crt_powers_dev.clear_cache()
    jpub, jpriv, pub, priv = keys
    cts = [pub.raw_encrypt(m, r_value=r) for m, r in
           zip(range(3, 10), _pinned(pub, 7, 71))]
    mine, theirs = _crt_powers_pair(jpriv, priv, cts)
    _check_crt_powers(mine, theirs, priv, cts)


def test_crt_powers_array_equal_to_phe_tpu_at_2048_bits():
    """The fixed 2048-bit key on a few rows: mont_pow_shared at L = 152."""
    pub, priv = benchmarks.fixed_key(2048)
    jpub = phe_tpu.PaillierPublicKey(pub.n)
    jpriv = phe_tpu.PaillierPrivateKey(jpub, priv.p, priv.q)
    cts = [pub.raw_encrypt(m, r_value=r) for m, r in
           zip((0, 1, 12345, pub.n - 1), _pinned(pub, 4, 72))]
    # 1,260 products of 4 rows each: small ops, which more threads slow.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mine, theirs = _crt_powers_pair(jpriv, priv, cts)
    finally:
        torch.set_num_threads(threads)
    assert mine[0].shape == (4, 152)
    _check_crt_powers(mine, theirs, priv, cts)
