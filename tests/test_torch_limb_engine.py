"""The port's limb-engine fallback against phe_tpu's limb route.

Past the RNS channel-prime supply (n^2 above ~8,760 bits) the port runs
its modexps on the limb engine, as phe_tpu does on its chip. On the CPU,
at a 256-bit key, phe_tpu runs its limb route (PHE_TPU_ENGINE=limb, with
PHE_TPU_BACKEND=xla, and pallas in interpret mode for one test) and the
port the plain versions of its limb kernels, with rns_state patched to
None (the package itself has no knob). Ciphertext ints, decrypted
residues, compact-decode rows and decoded values are equal: tolerance
zero, all exact integer arithmetic. The last two tests check where the
supply ends, with the real builders at 8,800 and 8,192 bits.
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

A = [1.5, -2.0, 300.0, 0.0625, 7, -1e-3, 12345.678]
B = [2.5e-3, 7.0, -1.0, 4.0, -3.25, 1e6, 0.5]
SCALARS = [3.0, -0.5, 2.0, -16.0, 1.0, -7.25, 1e-3]


@pytest.fixture(autouse=True)
def _phe_tpu_limb_route(monkeypatch):
    monkeypatch.setenv("PHE_TPU_ENGINE", "limb")
    monkeypatch.setenv("PHE_TPU_BACKEND", "xla")


@pytest.fixture
def limb(monkeypatch):
    """The port on its limb engine: both contexts answer as past the supply."""
    monkeypatch.setattr(tbatch.PublicDeviceContext, "rns_state",
                        lambda self: None)
    monkeypatch.setattr(tbatch.PrivateDeviceContext, "rns_state",
                        lambda self: None)


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
    return (pt.EncryptedBatch.encrypt(pub, values, r_values=rs, device="cpu"),
            jbatch.EncryptedBatch.encrypt(jpub, values, r_values=rs))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_pinned_encrypt_equal_phe_tpu_limb_route(keys, limb, monkeypatch,
                                                 backend):
    monkeypatch.setenv("PHE_TPU_BACKEND", backend)
    jpub, _, pub, _ = keys
    got, want = _pair(keys, A, 61)
    ints = got.ciphertext_ints(be_secure=False)
    assert ints == want.ciphertext_ints(be_secure=False)
    rs = _pinned(pub, len(A), 61)
    assert ints == [pub.raw_encrypt(e.encoding, r_value=r) for e, r in
                    zip(pt.EncodedNumber.encode_many(pub, A), rs)]


def test_reobfuscation_with_pinned_r_equal(keys, limb):
    jpub, _, pub, _ = keys
    got, want = _pair(keys, A, 62)
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


def test_mixed_sign_mul_scalars_equal(keys, limb):
    _, jpriv, _, priv = keys
    got, want = _pair(keys, A, 64)
    mine, theirs = got * SCALARS, want * SCALARS
    assert mine.ciphertext_ints(False) == theirs.ciphertext_ints(False)
    assert mine.decrypt(priv) == theirs.decrypt(jpriv) == [
        x * y for x, y in zip(A, SCALARS)]


def test_aligned_add_and_sum_equal(keys, limb):
    _, jpriv, _, priv = keys
    a, ja = _pair(keys, A, 65)
    b, jb = _pair(keys, B, 66)
    mine, theirs = a + b, ja + jb
    assert mine.ciphertext_ints(False) == theirs.ciphertext_ints(False)
    assert mine.decrypt(priv) == theirs.decrypt(jpriv) == [
        x + y for x, y in zip(A, B)]
    s, js = a.sum(), ja.sum()
    assert s.ciphertext_ints(False) == js.ciphertext_ints(False)
    assert s.decrypt(priv) == js.decrypt(jpriv)


def test_decrypt_residue_limb_and_compact_rows_equal(keys, limb):
    jpub, jpriv, pub, priv = keys
    got, want = _pair(keys, A, 67)
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


def test_phe_tpu_limb_batch_decrypts_in_the_port(keys, limb):
    jpub, _, pub, priv = keys
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
    8192-bit key: 56,448 bytes of shared memory a block, above the 48 KB
    default, which the launch raises) and refuses a context whose 48 L
    bytes pass the 227 KB a Hopper block can have."""
    from phe_tpu_torch.ops import _build, cuda_modexp
    from phe_tpu_torch.ops import montgomery as mg

    calls = []
    monkeypatch.setattr(cuda_modexp, "_lib",
                        lambda: lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(_build, "stream_handle", lambda device: None)
    monkeypatch.setitem(cuda_modexp.launches, "mont_mul", 0)
    ctx = mg.build_context((1 << 16383) + 1, "cpu")
    a = torch.zeros((3, 1176), dtype=torch.int64)
    assert cuda_modexp._launch(a, a, ctx, shared=False).shape == (3, 1176)
    assert len(calls) == 1 and calls[0][5:7] == (3, 1176)
    assert cuda_modexp.launches["mont_mul"] == 1
    wide = mg.build_context((1 << 68000) + 1, "cpu")
    assert 48 * wide.num_limbs > cuda_modexp.MAX_SMEM
    b = torch.zeros((1, wide.num_limbs), dtype=torch.int64)
    with pytest.raises(ValueError, match="48 L <= 232448"):
        cuda_modexp._launch(b, b, wide, shared=False)
