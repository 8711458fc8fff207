"""phe_tpu_torch host layer and limb math against phe_tpu, on the CPU.

Inputs come from numpy's seeded generator and go through both packages;
everything here is exact integer arithmetic, so every comparison is
array-equal (tolerance zero). Also: importing the port pulls in neither
jax nor phe_tpu.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phe_tpu
from phe_tpu.encoding import EncodedNumber as JEncoded
from phe_tpu.ops import limb_math as jlm
from phe_tpu.utils import limbs as jhl

import phe_tpu_torch as pt
from phe_tpu_torch.ops import limb_math as lm
from phe_tpu_torch.utils import limbs as hl
from phe_tpu_torch.utils import ntheory


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return np.asarray(x).astype(np.int64)


def _rng(seed):
    return np.random.default_rng(seed)


def _limbs(rng, shape, top=(1 << 14) + 1):
    return rng.integers(0, top, size=shape, dtype=np.int64)


def _both(a):
    return jnp.asarray(a.astype(np.uint32)), torch.as_tensor(a)


@pytest.mark.parametrize("name", ["carry_pass", "carry_fix", "normalize"])
def test_carry_functions(name):
    rng = _rng(1)
    # carry_fix is sound for slots < 2**31; normalize for any limbs.
    top = (1 << 31) - 1 if name != "normalize" else 1 << 20
    a = _limbs(rng, (7, 24), top)
    a[:, -1] = 0  # keep the value inside the array's capacity
    ja, ta = _both(a)
    want = _np(getattr(jlm, name)(ja))
    got = getattr(lm, name)(ta).numpy()
    np.testing.assert_array_equal(got, want)


def test_add_mul_full_mul_low_diag_sum():
    rng = _rng(2)
    a, b = _limbs(rng, (5, 16)), _limbs(rng, (5, 16))
    a[:, -1] = b[:, -1] = 0
    (ja, ta), (jb, tb) = _both(a), _both(b)
    np.testing.assert_array_equal(lm.add(ta, tb).numpy(), _np(jlm.add(ja, jb)))
    np.testing.assert_array_equal(
        lm.mul_full(ta, tb).numpy(), _np(jlm.mul_full(ja, jb))
    )
    np.testing.assert_array_equal(
        lm.mul_low(ta, tb, 9).numpy(), _np(jlm.mul_low(ja, jb, 9))
    )
    m = _limbs(rng, (3, 4, 6))
    jm, tm = _both(m)
    np.testing.assert_array_equal(lm.diag_sum(tm).numpy(), _np(jlm.diag_sum(jm)))
    # Broadcast operand, as the Montgomery constants are used.
    np.testing.assert_array_equal(
        lm.mul_full(ta, tb[0]).numpy(),
        _np(jlm.mul_full(ja, jnp.broadcast_to(jb[0], ja.shape))),
    )


def test_shift_right_limbs_exact():
    rng = _rng(3)
    hi = _limbs(rng, (6, 8), 1 << 14)
    low = np.zeros((6, 8), np.int64)
    low[::2, -1] = 1 << 14  # redundant encodings of exactly R
    x = np.concatenate([low, hi], axis=1)
    jx, tx = _both(x)
    np.testing.assert_array_equal(
        lm.shift_right_limbs_exact(tx, 8).numpy(),
        _np(jlm.shift_right_limbs_exact(jx, 8)),
    )


def test_pack_unpack_bytes():
    rng = _rng(4)
    x = _limbs(rng, (5, 19), 1 << 14)
    jx, tx = _both(x)
    np.testing.assert_array_equal(
        lm.pack_bytes(tx).numpy(), np.asarray(jlm.pack_bytes(jx))
    )
    buf = rng.integers(0, 256, size=(5, 31), dtype=np.uint8)
    np.testing.assert_array_equal(
        lm.unpack_bytes(torch.as_tensor(buf), 20).numpy(),
        _np(jlm.unpack_bytes(jnp.asarray(buf), 20)),
    )


def test_cond_sub():
    rng = _rng(5)
    width = 10
    M = int(rng.integers(1, 1 << 62)) << 70 | 12345
    R = 1 << (14 * width)
    xs = [int(v) % (2 * M) for v in rng.integers(0, 1 << 62, 6)] + [M, M - 1]
    x = hl.ints_to_limbs(xs, width).astype(np.int64)
    comp = hl.int_to_limbs(R - M, width).astype(np.int64)
    jx, tx = _both(x)
    jc, tc = _both(comp)
    got = lm.cond_sub(tx, tc, width).numpy()
    np.testing.assert_array_equal(got, _np(jlm.cond_sub(jx, jc, width)))
    assert hl.limbs_to_ints(got) == [v % M for v in xs]


def test_matmul_exact_is_integer_exact():
    rng = _rng(6)
    x = rng.integers(-64, 128, size=(9, 600), dtype=np.int64)
    w = rng.integers(0, 128, size=(600, 7), dtype=np.int64)
    got = lm.matmul_exact(torch.as_tensor(x).to(torch.int8),
                          torch.as_tensor(w).to(torch.int8))
    np.testing.assert_array_equal(got.numpy(), x @ w)


@pytest.mark.parametrize("nbits", [256, 2048])
def test_host_limb_conversions(nbits):
    rng = _rng(7)
    vals = [int.from_bytes(rng.bytes(nbits // 8), "little") for _ in range(5)]
    L = hl.num_limbs_for_bits(nbits)
    np.testing.assert_array_equal(
        hl.ints_to_limbs(vals, L), jhl.ints_to_limbs(vals, L)
    )
    np.testing.assert_array_equal(
        hl.ints_to_bytes(vals, nbits // 8), jhl.ints_to_bytes(vals, nbits // 8)
    )
    assert hl.limbs_to_ints(hl.ints_to_limbs(vals, L)) == vals


def test_encode_many_matches_phe_tpu():
    pub = pt.PaillierPublicKey(phe_tpu.generate_paillier_keypair(
        n_length=256)[0].n)
    jpub = phe_tpu.PaillierPublicKey(pub.n)
    rng = _rng(8)
    values = [float(v) for v in rng.uniform(-1e6, 1e6, 20)] + [0, -7, 1 << 60]
    got = [(e.encoding, e.exponent)
           for e in pt.EncodedNumber.encode_many(pub, values)]
    want = [(e.encoding, e.exponent) for e in JEncoded.encode_many(jpub, values)]
    assert got == want


def test_keys_and_scalar_layer_match_phe_tpu():
    jpub, jpriv = phe_tpu.generate_paillier_keypair(n_length=256)
    pub = pt.PaillierPublicKey(jpub.n)
    priv = pt.PaillierPrivateKey(pub, jpriv.p, jpriv.q)
    assert (priv.hp, priv.hq, priv.p_inverse) == (
        jpriv.hp, jpriv.hq, jpriv.p_inverse)
    c = pub.raw_encrypt(10100, r_value=74384)
    assert c == jpub.raw_encrypt(10100, r_value=74384)
    assert priv.raw_decrypt(c) == 10100
    enc = pub.encrypt(-2.5)
    assert priv.decrypt(enc * 2 + 1) == -4.0
    ring = pt.PaillierPrivateKeyring([priv])
    assert ring.decrypt(enc) == -2.5


def test_ntheory():
    assert ntheory.is_prime(17863) and not ntheory.is_prime(17861)
    p = ntheory.getprimeover(64)
    assert p.bit_length() == 64 and ntheory.is_prime(p)
    assert ntheory.invert(3, 7) == 5
    with pytest.raises(ZeroDivisionError):
        ntheory.invert(2, 4)


def test_port_imports_neither_jax_nor_phe_tpu():
    code = (
        "import sys, phe_tpu_torch, phe_tpu_torch.batch, "
        "phe_tpu_torch.interop, phe_tpu_torch.ops.cuda_modexp, "
        "phe_tpu_torch.ops.cuda_rns, phe_tpu_torch.ops._build, "
        "phe_tpu_torch.models, phe_tpu_torch.models.logreg, "
        "phe_tpu_torch.models.federated, phe_tpu_torch.microbench, "
        "phe_tpu_torch.profiling, phe_tpu_torch.benchmarks, "
        "phe_tpu_torch.bench, phe_tpu_torch.ops.cuda_microbench, "
        "chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'phe_tpu' "
        "or m.startswith('phe_tpu.') or m == '__graft_entry__')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=_REPO)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cuda_requested_without_a_card_raises(monkeypatch):
    from phe_tpu_torch import config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        config.resolve_device(None)
    assert config.resolve_device("cpu") == torch.device("cpu")
