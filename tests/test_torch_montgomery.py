"""phe_tpu_torch's Montgomery layer against phe_tpu, on the CPU.

Inputs come from numpy's seeded generator and go through both packages.
Everything is exact integer arithmetic, so every tolerance is zero: host
builders and canonical outputs are array-equal; Montgomery products and
the windowed modexps (shared and per-element exponent) are held, as
phe_tpu's own tests hold its Pallas kernels, value-equal mod M (the
redundant limbs may differ) and inside the kernel contract's bounds (limbs
in [0, 2^14], value < 1.01 M for inputs below 2.01 M). phe_tpu's Pallas
kernels run here in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phe_tpu
from phe_tpu.ops import limb_math as jlm
from phe_tpu.ops import montgomery as jmg
from phe_tpu.ops import pallas_modexp as jpmx

from phe_tpu_torch import interop
from phe_tpu_torch.ops import cuda_modexp
from phe_tpu_torch.ops import montgomery as mg
from phe_tpu_torch.utils import limbs as hl
from __graft_entry__ import _P, _Q

CPU = torch.device("cpu")


def _modulus(rng, bits):
    """A random odd modulus of exactly `bits` bits."""
    v = int.from_bytes(rng.bytes((bits + 7) // 8), "little")
    return (v & ((1 << bits) - 1)) | (1 << (bits - 1)) | 1


def _operands(rng, M, L, rows):
    """[rows, L] int64 limbs of values < 2.01 M, half of them redundant.

    Even rows are canonical values in [0, 2M). Odd rows hold random limbs
    in [0, 2^14] below M's top limb, several forced to exactly 2^14 (the
    redundant maximum), so their values stay under 1.0001 M.
    """
    top = (M.bit_length() - 1) // 14  # M >= 2^(14 top)
    vals = [int.from_bytes(rng.bytes(8 * L), "little") % (2 * M)
            for _ in range(rows)]
    out = hl.ints_to_limbs(vals, L).astype(np.int64)
    for i in range(1, rows, 2):
        out[i] = 0
        out[i, :top] = rng.integers(0, (1 << 14) + 1, top)
        out[i, rng.integers(0, top, 4)] = 1 << 14
        out[i, 0] = 1 << 14
    return out


def _values(limbs):
    return hl.limbs_to_ints(np.asarray(limbs))


def _jctx(M):
    return jmg.build_context(M)


def _ctx_dict(c):
    return {f: np.asarray(getattr(c, f)) for f in mg.MontgomeryContext._fields}


def _assert_same_fields(got, want):
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if torch.is_tensor(a):
            assert a.dtype == b.dtype, f
            assert torch.equal(a, b), f
        else:
            assert a == b, f


@pytest.fixture(scope="module")
def keys():
    rng = np.random.default_rng(11)
    jpub, jpriv = phe_tpu.generate_paillier_keypair(n_length=256)
    return {
        256: (jpriv.p, jpriv.q, jpub.nsquare),
        2048: (_P, _Q, (_P * _Q) ** 2),
        "rng": rng,
    }


# -- host builders ------------------------------------------------------------


@pytest.mark.parametrize("bits", [256, 2048])
def test_builders_array_equal(keys, bits):
    p, q, nsq = keys[bits]
    for M in (nsq, p * p, q * q, p):
        got = mg.build_context(M, CPU)
        _assert_same_fields(got, interop.montgomery_context(
            _ctx_dict(_jctx(M)), CPU))
        if bits == 2048 and M == nsq:
            assert got.num_limbs == 296
    # Half-width contexts share one limb count.
    Lh = mg.build_context(p, CPU).num_limbs
    _assert_same_fields(
        mg.build_context(q, CPU, num_limbs=Lh),
        interop.montgomery_context(
            _ctx_dict(jmg.build_context(q, num_limbs=Lh)), CPU),
    )
    for M, W in ((nsq, Lh * 4 + 8), (p * p, Lh * 2 + 8)):
        jr = jmg.build_excess_reducer(M, W)
        got = mg.build_excess_reducer(M, W, CPU)
        _assert_same_fields(got, interop.excess_reducer(
            {f: np.asarray(getattr(jr, f)) for f in jr._fields}, CPU))
        assert (got.i0, got.r) == (jr.i0, jr.r)
    Rh = 1 << (14 * Lh)
    for c, out in ((pow(p, -1, Rh), Lh), (p, 2 * Lh)):
        _assert_same_fields(
            mg.build_const_mul(c, Lh, out, CPU),
            interop.const_mul_table(
                {"w": np.asarray(jmg.build_const_mul(c, Lh, out).w)}, CPU),
        )
    Lw = mg.build_context(nsq, CPU).num_limbs
    ctx2 = mg.build_context(p * p, CPU)
    jt = jmg.build_reduce_table(p * p, _jctx(p * p), Lw)
    _assert_same_fields(
        mg.build_reduce_table(p * p, ctx2, Lw, CPU),
        interop.reduce_table(
            {f: np.asarray(getattr(jt, f)) for f in jt._fields}, CPU),
    )


def test_exponent_digits_match(keys):
    p, q, nsq = keys[2048]
    for e, bits, w in ((p - 1, 1024, 5), (p * q, 2048, 5), (12345, 64, 4)):
        np.testing.assert_array_equal(
            mg.exponent_digits(e, bits, w),
            np.asarray(jmg.exponent_digits(e, bits, w)).astype(np.int64),
        )


def test_reduce_table_refuses_past_the_carry_bound():
    M = (1 << 200) + 235
    ctx = mg.build_context(M, CPU)
    L = ctx.num_limbs
    mg.build_reduce_table(M, ctx, L + mg.MAX_FOLD_LIMBS, CPU)
    with pytest.raises(ValueError, match="carry bound"):
        mg.build_reduce_table(M, ctx, L + mg.MAX_FOLD_LIMBS + 1, CPU)


# -- Montgomery products --------------------------------------------------------


@pytest.mark.parametrize("bits,L", [(300, 24), (1024, 80)])
@pytest.mark.parametrize("shared", [False, True], ids=["two", "shared"])
def test_mont_mul_value_equal(keys, bits, L, shared):
    rng = np.random.default_rng(bits + shared)
    M = _modulus(rng, bits)
    ctx = mg.build_context(M, CPU)
    jctx = _jctx(M)
    assert ctx.num_limbs == L
    rows = 12
    a = _operands(rng, M, L, rows)
    b = _operands(rng, M, L, 1 if shared else rows)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b[0] if shared else b)
    ja = jnp.asarray(a.astype(np.uint32))
    jb = jnp.asarray(b.astype(np.uint32))
    if shared:
        got = cuda_modexp.mont_mul_const(ta, tb, ctx)
        kernel = jpmx.mont_mul_const(ja, jb[0], jctx, tb=8)
        plain = jmg.redc(jlm.mul_full(ja, jnp.broadcast_to(jb[0], ja.shape)),
                         jctx)
    else:
        got = cuda_modexp.mont_mul(ta, tb, ctx)
        kernel = jpmx.mont_mul(ja, jb, jctx, tb=8)
        plain = jmg.redc(jlm.mul_full(ja, jb), jctx)
    R_inv = pow(1 << (14 * L), -1, M)
    xs, ys = _values(a), _values(b)
    want = [x * (ys[0] if shared else y) * R_inv % M
            for x, y in zip(xs, ys * rows if shared else ys)]
    got_v = _values(got.numpy())
    assert [v % M for v in got_v] == want
    assert [v % M for v in _values(kernel)] == want
    assert [v % M for v in _values(plain)] == want
    assert got.shape == (rows, L) and got.dtype == torch.int64
    assert int(got.min()) >= 0 and int(got.max()) <= 1 << 14
    assert all(100 * v < 101 * M for v in got_v)


def test_to_from_mont_and_export_match(keys):
    rng = keys["rng"]
    p, q, nsq = keys[256]
    ctx, jctx = mg.build_context(nsq, CPU), _jctx(nsq)
    L = ctx.num_limbs
    x = _operands(rng, nsq, L, 6)
    x[1::2] = hl.ints_to_limbs(
        [v % nsq for v in _values(x[1::2])], L)  # to_mont takes < M
    tx, jx = torch.as_tensor(x), jnp.asarray(x.astype(np.uint32))
    xm = mg.to_mont(tx, ctx)
    jxm = jmg.to_mont(jx, jctx)
    R = 1 << (14 * L)
    assert [v % nsq for v in _values(xm.numpy())] == [
        v % nsq for v in _values(jxm)] == [v * R % nsq for v in _values(x)]
    back = mg.export_canonical(mg.from_mont(xm, ctx), ctx)
    jback = jmg.export_canonical(jmg.from_mont(jxm, jctx), jctx)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback, np.int64))
    assert _values(back.numpy()) == [v % nsq for v in _values(x)]
    with pytest.raises(ValueError, match="exactly L"):
        mg.to_mont(torch.nn.functional.pad(tx, (0, 1)), ctx)


def test_reduce_excess_const_mul_mod_reduce_match(keys):
    rng = np.random.default_rng(21)
    p, q, nsq = keys[256]
    M = p * p
    # reduce_excess: canonical inputs up to 2^10 M.
    W = mg.num_limbs_for_modulus(M.bit_length()) + 2
    red, jred = mg.build_excess_reducer(M, W, CPU), jmg.build_excess_reducer(M, W)
    vals = [int.from_bytes(rng.bytes(64), "little") % ((1 << 10) * M)
            for _ in range(7)] + [0, M - 1, M, (1 << 10) * M]
    v = hl.ints_to_limbs(vals, W).astype(np.int64)
    got = mg.reduce_excess(torch.as_tensor(v), red).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jmg.reduce_excess(jnp.asarray(v.astype(np.uint32)),
                                          jred), np.int64))
    assert _values(got) == [x % M for x in vals]
    # const_mul: redundant limbs <= 2^16 in, product mod 2^(14 out).
    Lh = mg.build_context(p, CPU).num_limbs
    c = pow(p, -1, 1 << (14 * Lh))
    table, jtable = (mg.build_const_mul(c, Lh, Lh, CPU),
                     jmg.build_const_mul(c, Lh, Lh))
    a = rng.integers(0, (1 << 16) + 1, (6, Lh), dtype=np.int64)
    got = mg.const_mul(torch.as_tensor(a), table).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jmg.const_mul(jnp.asarray(a.astype(np.uint32)),
                                      jtable), np.int64))
    assert [v % (1 << (14 * Lh)) for v in _values(got)] == [
        x * c % (1 << (14 * Lh)) for x in _values(a)]
    # mod_reduce: the wide fold (K >= 8) and the narrow one (K < 8).
    ctx2, jctx2 = mg.build_context(M, CPU), _jctx(M)
    L2 = ctx2.num_limbs
    for Lw in (mg.build_context(nsq, CPU).num_limbs, L2 + 5):
        rt = mg.build_reduce_table(M, ctx2, Lw, CPU)
        jrt = jmg.build_reduce_table(M, jctx2, Lw)
        x = rng.integers(0, 1 << 14, (5, Lw), dtype=np.int64)
        got = mg.mod_reduce(torch.as_tensor(x), ctx2, rt).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jmg.mod_reduce(jnp.asarray(x.astype(np.uint32)),
                                           jctx2, jrt), np.int64))
        assert [v % M for v in _values(got)] == [v % M for v in _values(x)]
        assert all(2 * v < 3 << (14 * L2) for v in _values(got))


# -- windowed modexps -------------------------------------------------------------


@pytest.mark.parametrize("bits,window", [(256, 4), (520, 5)])
def test_mont_pow_shared_value_equal(bits, window):
    rng = np.random.default_rng(bits + window)
    M = _modulus(rng, bits)
    ctx, jctx = mg.build_context(M, CPU), _jctx(M)
    L = ctx.num_limbs
    base = _operands(rng, M, L, 5)
    e = int.from_bytes(rng.bytes(24), "little") | (1 << 191)
    digits = mg.exponent_digits(e, 192, window)
    got = cuda_modexp.mont_pow_shared(torch.as_tensor(base), digits, ctx,
                                      window=window)
    jb = jnp.asarray(base.astype(np.uint32))
    jd = jnp.asarray(digits, jnp.int32)
    xla = jmg._mont_pow_shared_xla(jb, jd, jctx, window=window)
    kernel = jpmx.mont_pow_shared(jb, jd, jctx, window=window, tb=8)
    R = 1 << (14 * L)
    Rinv = pow(R, -1, M)
    want = [pow(x * Rinv, e, M) * R % M for x in _values(base)]
    got_v = _values(got.numpy())
    for out in (got_v, _values(xla), _values(kernel)):
        assert [v % M for v in out] == want
    assert int(got.min()) >= 0 and int(got.max()) <= 1 << 14
    assert all(100 * v < 101 * M for v in got_v)


@pytest.mark.parametrize("bits", [256, 520])
def test_mont_pow_per_element_value_equal(bits):
    rng = np.random.default_rng(bits + 3)
    M = _modulus(rng, bits)
    ctx, jctx = mg.build_context(M, CPU), _jctx(M)
    L = ctx.num_limbs
    es = [0, 1, 2, 0x1234567, int(rng.integers(1, 1 << 62)),
          int.from_bytes(rng.bytes(10), "little"), (1 << 80) - 1]
    base = _operands(rng, M, L, len(es))
    digits = np.stack([mg.exponent_digits(e, 80) for e in es])
    got = mg.mont_pow(torch.as_tensor(base), digits.astype(np.int8), ctx)
    jb = jnp.asarray(base.astype(np.uint32))
    jd = jnp.asarray(digits, jnp.int32)
    xla = jmg._mont_pow_xla(jb, jd, jctx)
    kernel = jpmx.mont_pow(jb, jd, jctx, tb=8)
    R = 1 << (14 * L)
    Rinv = pow(R, -1, M)
    want = [pow(x * Rinv, e, M) * R % M for x, e in zip(_values(base), es)]
    got_v = _values(got.numpy())
    for out in (got_v, _values(xla), _values(kernel)):
        assert [v % M for v in out] == want
    assert int(got.min()) >= 0 and int(got.max()) <= 1 << 14
    assert all(100 * v < 101 * M for v in got_v)
    # Leading dims flatten through the dispatcher.
    grid = mg.mont_pow(torch.as_tensor(base[:6]).reshape(2, 3, L),
                       digits[:6].reshape(2, 3, -1), ctx)
    assert _values(grid.reshape(6, L).numpy()) == got_v[:6]


# -- the wrapper's dispatch -------------------------------------------------------


def test_wrapper_takes_plain_version_only_on_cpu():
    M = (1 << 300) + 1155
    ctx = mg.build_context(M, CPU)
    a = torch.zeros((3, ctx.num_limbs), dtype=torch.int64)
    before = dict(cuda_modexp.launches)
    cuda_modexp.mont_mul(a, a, ctx)
    cuda_modexp.mont_mul_const(a, a[0], ctx)
    cuda_modexp.mont_pow(a, np.ones((3, 2), np.int8), ctx)
    cuda_modexp.mont_pow_shared(a, [1, 2], ctx)
    assert cuda_modexp.launches == before  # the plain versions launch nothing
    with pytest.raises(ValueError, match="no Montgomery product"):
        cuda_modexp.mont_mul(a.to("meta"), a.to("meta"), ctx)
    for fn in (cuda_modexp.mont_pow, cuda_modexp.mont_pow_shared):
        with pytest.raises(ValueError, match="no Montgomery modexp"):
            fn(a.to("meta"), [1], ctx)
