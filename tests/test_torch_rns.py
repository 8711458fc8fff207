"""phe_tpu_torch's RNS layer against phe_tpu, on the CPU.

Every residue in the Cox-Rower product is canonical, so the port computes
the same integers as phe_tpu at every step: builders, conversions, the
fused product and the plain ladders (shared and per-element exponent) are
all held array-equal (tolerance zero) to phe_tpu's rns module and to its
Pallas ladder kernels, which run here in interpret mode as phe_tpu's own
tests run them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phe_tpu
from phe_tpu.ops import pallas_rns as jprns
from phe_tpu.ops import rns as jrns

import phe_tpu_torch as pt
from phe_tpu_torch import interop
from phe_tpu_torch.ops import cuda_rns
from phe_tpu_torch.ops import montgomery as mg
from phe_tpu_torch.ops import rns
from phe_tpu_torch.utils import limbs as hl
from __graft_entry__ import _P, _Q

CPU = torch.device("cpu")


def _dict(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def _assert_same(got, want):
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        assert torch.equal(a, b), f


def _j(x):
    return jnp.asarray(np.asarray(x).astype(np.uint32))


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.fixture(scope="module")
def small():
    """A 128-bit key's n^2 system, in both packages, with its conversion."""
    pub, _ = phe_tpu.generate_paillier_keypair(n_length=128)
    N = pub.nsquare
    Lin = hl.num_limbs_for_bits(N.bit_length())
    jsys = jrns.build_rns(N)
    sys_ = rns.build_rns(N, CPU)
    return (pub, N, Lin, sys_, rns.build_conversion(sys_, Lin), jsys,
            jrns.build_conversion(jsys, Lin))


def _inputs(rng, N, k, Lin, rows):
    """Values < 2kN (the ladder's input bound), as [rows, Lin] limbs."""
    xs = [int.from_bytes(rng.bytes(8 * Lin), "little") % (2 * k * N)
          for _ in range(rows - 2)] + [0, 1]
    return xs, hl.ints_to_limbs(xs, Lin).astype(np.int64)


@pytest.mark.parametrize("bits", [128, 256, 2048])
def test_builders_array_equal(bits):
    if bits == 2048:
        p, q = _P, _Q
    else:
        _, priv = phe_tpu.generate_paillier_keypair(n_length=bits)
        p, q = priv.p, priv.q
    mods = [(p * q) ** 2, p * p] + ([q * q] if bits != 2048 else [])
    for N in mods:
        sys_ = rns.build_rns(N, CPU)
        jsys = jrns.build_rns(N)
        _assert_same(sys_, interop.rns_system(_dict(jsys), CPU))
        L = mg.num_limbs_for_modulus(N.bit_length())
        _assert_same(rns.build_conversion(sys_, L),
                     interop.rns_conversion(
                         _dict(jrns.build_conversion(jsys, L)), CPU))
        E = pow(3, p, N)
        assert torch.equal(rns.residues(E, sys_),
                           torch.as_tensor(_np(jrns.residues(E, jsys))))
        if bits == 2048:
            want = (304, 616, 296) if N == (p * q) ** 2 else (152, 312, 152)
            assert (sys_.k, sys_.cpad, L) == want


def test_conversions_and_product_bit_equal(small):
    pub, N, Lin, sys_, conv, jsys, jconv = small
    rng = np.random.default_rng(31)
    _, x = _inputs(rng, N, sys_.k, Lin, 9)
    _, y = _inputs(rng, N, sys_.k, Lin, 9)
    xr = rns.to_rns(torch.as_tensor(x), conv, sys_)
    yr = rns.to_rns(torch.as_tensor(y), conv, sys_)
    jxr, jyr = jrns.to_rns(_j(x), jconv, jsys), jrns.to_rns(_j(y), jconv, jsys)
    np.testing.assert_array_equal(xr.numpy(), _np(jxr))
    np.testing.assert_array_equal(yr.numpy(), _np(jyr))
    prod = rns.rns_mont_mul(xr, yr, sys_)
    np.testing.assert_array_equal(
        prod.numpy(), _np(jrns.rns_mont_mul(jxr, jyr, jsys)))
    np.testing.assert_array_equal(
        rns.from_rns(prod, sys_).numpy(),
        _np(jrns.from_rns(jrns.rns_mont_mul(jxr, jyr, jsys), jsys)))


@pytest.mark.parametrize("window,consts", [(4, False), (5, True)])
def test_ladder_bit_equal_to_pallas_and_xla(small, window, consts):
    pub, N, Lin, sys_, conv, jsys, jconv = small
    rng = np.random.default_rng(41 + window)
    xs, x = _inputs(rng, N, sys_.k, Lin, 6)
    e = pub.n
    digits = rns.rns_pow_digits(e, e.bit_length(), window)
    F, E = (pow(5, 77, N), pow(7, 99, N)) if consts else (1, 1)
    exit_res = entry_res = None
    jexit = jentry = None
    if consts:
        M_A = 1
        for a in sys_.m[: sys_.k].tolist():
            M_A *= a
        exit_res, jexit = rns.residues(E, sys_), jrns.residues(E, jsys)
        entry_res = rns.residues(M_A * M_A * F % N, sys_)
        jentry = jrns.residues(M_A * M_A * F % N, jsys)
    xr = rns.to_rns(torch.as_tensor(x), conv, sys_)
    got = rns.ladder_plain(xr, digits, sys_, window=window,
                           exit_res=exit_res, entry_res=entry_res)
    kernel = jprns.ladder_cols(
        _j(xr.numpy()).T, jnp.asarray(digits, jnp.int32), jsys,
        window=window, exit_res=jexit, entry_res=jentry).T
    np.testing.assert_array_equal(got.numpy(), _np(kernel))
    limbs = rns.pow_shared(torch.as_tensor(x), digits, conv, sys_,
                           window=window, exit_res=exit_res,
                           entry_res=entry_res)
    ref = jrns.pow_shared_xla(_j(x), jnp.asarray(digits, jnp.int32), jconv,
                              jsys, window=window, exit_res=jexit,
                              entry_res=jentry)
    np.testing.assert_array_equal(limbs.numpy(), _np(ref))
    out = hl.limbs_to_ints(limbs.numpy())
    assert all(v <= sys_.k * N + 1 for v in out)
    assert [v % N for v in out] == [pow(x * F, e, N) * E % N for x in xs]


def _vec_case(small, window, consts, seed):
    """Inputs, per-element schedules and constants for the vec ladder:
    exponents of mixed widths, with 0 and 1 (the pad rows' exponent)."""
    pub, N, Lin, sys_, conv, jsys, jconv = small
    rng = np.random.default_rng(seed)
    xs, x = _inputs(rng, N, sys_.k, Lin, 8)
    es = [0, 1, 2, 15, int(rng.integers(1, 1 << 20)),
          int(rng.integers(1, 1 << 62)), (1 << 64) - 1, 1 << 63]
    bits = max(e.bit_length() for e in es)
    digits = np.stack([rns.rns_pow_digits(e, bits, window) for e in es])
    F, E = (pow(5, 77, N), pow(7, 99, N)) if consts else (1, 1)
    c = dict(exit_res=None, entry_res=None)
    jc = dict(exit_res=None, entry_res=None)
    if consts:
        M_A = 1
        for a in sys_.m[: sys_.k].tolist():
            M_A *= a
        c = dict(exit_res=rns.residues(E, sys_),
                 entry_res=rns.residues(M_A * M_A * F % N, sys_))
        jc = dict(exit_res=jrns.residues(E, jsys),
                  entry_res=jrns.residues(M_A * M_A * F % N, jsys))
    return xs, x, es, digits, F, E, c, jc


@pytest.mark.parametrize("window,consts",
                         [(4, False), (4, True), (5, False), (5, True)])
def test_ladder_vec_bit_equal_to_pallas_and_xla(small, window, consts):
    pub, N, Lin, sys_, conv, jsys, jconv = small
    xs, x, es, digits, F, E, c, jc = _vec_case(small, window, consts,
                                               51 + window + consts)
    xr = rns.to_rns(torch.as_tensor(x), conv, sys_)
    got = rns.ladder_vec_plain(xr, digits, sys_, window=window, **c)
    kernel = jprns.ladder_vec_cols(
        _j(xr.numpy()).T, jnp.asarray(digits.T, jnp.int32), jsys,
        window=window, tb=8, **jc).T
    np.testing.assert_array_equal(got.numpy(), _np(kernel))
    limbs = rns.pow_vec(torch.as_tensor(x), digits.astype(np.int8), conv,
                        sys_, window=window, **c)
    ref = jrns.pow_vec_xla(_j(x), jnp.asarray(digits, jnp.int32), jconv,
                           jsys, window=window, **jc)
    np.testing.assert_array_equal(limbs.numpy(), _np(ref))
    rows = jprns.pow_vec_rows(_j(x), jnp.asarray(digits, jnp.int32), jconv,
                              jsys, window=window, **jc)
    np.testing.assert_array_equal(limbs.numpy(), _np(rows))
    out = hl.limbs_to_ints(limbs.numpy())
    assert all(v <= sys_.k * N + 1 for v in out)
    assert [v % N for v in out] == [
        pow(x * F, e, N) * E % N for x, e in zip(xs, es)]


def test_ladder_vec_wrapper_dispatch_and_host_checks(small):
    pub, N, Lin, sys_, conv, jsys, jconv = small
    x = torch.zeros((3, sys_.cpad), dtype=torch.int64)
    digits = np.array([[0, 3], [1, 0], [15, 15]], np.int8)
    before = dict(cuda_rns.launches)
    assert torch.equal(cuda_rns.ladder_vec(x, digits, sys_),
                       rns.ladder_vec_plain(x, digits, sys_))
    assert cuda_rns.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="no RNS ladder"):
        cuda_rns.ladder_vec(x.to("meta"), digits, sys_)
    got = cuda_rns._digit_rows_on(digits.astype(np.int64), 4, 3, CPU)
    assert got.dtype == torch.int8 and torch.equal(
        got, torch.as_tensor(digits))
    for bad in ([[3, 16]] * 3, [[-1, 2]] * 3):
        with pytest.raises(ValueError, match="2\\^window"):
            cuda_rns._digit_rows_on(np.array(bad), 4, 3, CPU)
    with pytest.raises(ValueError, match="int8"):
        cuda_rns._digit_rows_on(digits[:2], 4, 3, CPU)


def test_modulus_past_the_channel_supply_raises():
    """build_rns raises ValueError past the supply, as phe_tpu's does; the
    public context then answers None and runs the limb engine."""
    with pytest.raises(ValueError, match="channel supply"):
        rns.build_rns((1 << 9000) + 1, CPU)
    pub = pt.PaillierPublicKey((1 << 4500) + 1)  # n^2 has 9,001 bits
    assert pub.device_context("cpu").rns_state() is None


def test_ladder_wrapper_dispatch(small):
    pub, N, Lin, sys_, conv, jsys, jconv = small
    x = torch.zeros((2, sys_.cpad), dtype=torch.int64)
    digits = rns.rns_pow_digits(3, 2)
    before = dict(cuda_rns.launches)
    assert torch.equal(cuda_rns.ladder(x, digits, sys_),
                       rns.ladder_plain(x, digits, sys_))
    assert cuda_rns.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="no RNS ladder"):
        cuda_rns.ladder(x.to("meta"), digits, sys_)


def test_ladder_wrapper_host_preparation(small):
    """What the kernel's wrapper prepares on the host, checked on the CPU:
    the packed extension matrices (built once per system) and the digit
    schedule's range check before upload."""
    pub, N, Lin, sys_, conv, jsys, jconv = small
    w1p, w2p = cuda_rns._columns(sys_)
    assert cuda_rns._columns(sys_)[0] is w1p  # cached per system
    for packed, w in ((w1p, sys_.w_ext1), (w2p, sys_.w_ext2)):
        assert packed.dtype == torch.int32 and packed.is_contiguous()
        assert torch.equal(packed.t().contiguous().view(torch.int8), w)
    digits = rns.rns_pow_digits(pub.n, pub.n.bit_length(), 5)
    got = cuda_rns._digits_on(digits, 5, CPU)
    assert got.dtype == torch.int64 and torch.equal(got, torch.as_tensor(digits))
    for bad in ([3, 16], [-1, 2]):
        with pytest.raises(ValueError, match="2\\^window"):
            cuda_rns._digits_on(np.array(bad), 4, CPU)
