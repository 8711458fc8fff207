"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips with a reason where torch.cuda.is_available() is False. The file
imports neither jax nor phe_tpu, so it runs on a machine with only
PyTorch and the CUDA toolkit (the tests' conftest imports jax, hence
--noconftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Montgomery products and the limb-engine modexps are held value-equal mod
M and inside the kernel contract's bounds; both ladders are held bit-equal
(every residue is canonical). Tolerance zero throughout: all exact integer
arithmetic.
"""

import random

import numpy as np
import pytest
import torch

import phe_tpu_torch as pt
from phe_tpu_torch import batch as tbatch
from phe_tpu_torch.ops import cuda_modexp, cuda_rns
from phe_tpu_torch.ops import montgomery as mg
from phe_tpu_torch.ops import rns
from phe_tpu_torch.utils import limbs as hl

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _limbs(values, L, dev):
    return mg._tensor(hl.ints_to_limbs(values, L), dev)


@pytest.mark.parametrize("bits", [300, 1024, 2048, 4096])
@pytest.mark.parametrize("shared", [False, True], ids=["two", "shared"])
def test_mont_mul_kernel_matches_plain(dev, bits, shared):
    rng = random.Random(bits + shared)
    M = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
    ctx = mg.build_context(M, dev)
    L = ctx.num_limbs
    rows = 67
    xs = [rng.randrange(0, 2 * M) for _ in range(rows)]
    ys = [rng.randrange(0, 2 * M) for _ in range(1 if shared else rows)]
    a, b = _limbs(xs, L, dev), _limbs(ys, L, dev)
    fn = cuda_modexp.mont_mul_const if shared else cuda_modexp.mont_mul
    name = "mont_mul_const" if shared else "mont_mul"
    before = cuda_modexp.launches[name]
    got = fn(a, b[0] if shared else b, ctx)
    assert cuda_modexp.launches[name] == before + 1
    plain = cuda_modexp.mont_mul_plain(a, b[0] if shared else b, ctx)
    torch.cuda.synchronize()
    R_inv = pow(1 << (14 * L), -1, M)
    want = [x * (ys[0] if shared else y) * R_inv % M
            for x, y in zip(xs, ys * rows if shared else ys)]
    g = hl.limbs_to_ints(got.cpu().numpy())
    assert [v % M for v in g] == want
    assert [v % M for v in hl.limbs_to_ints(plain.cpu().numpy())] == want
    assert int(got.min()) >= 0 and int(got.max()) <= 1 << 14
    assert all(100 * v < 101 * M for v in g)


def test_mont_mul_wrapper_checks(dev):
    ctx = mg.build_context((1 << 300) + 1155, dev)
    L = ctx.num_limbs
    a = torch.zeros((4, L), dtype=torch.int64, device=dev)
    with pytest.raises(TypeError, match="int64"):
        cuda_modexp.mont_mul(a.int(), a.int(), ctx)
    with pytest.raises(ValueError, match="limb count"):
        cuda_modexp.mont_mul(a[:, :-8].contiguous(), a[:, :-8].contiguous(),
                             ctx)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_modexp.mont_mul(a, a.t().contiguous().t(), ctx)
    with pytest.raises(ValueError, match="is on"):
        cuda_modexp.mont_mul(a, a.cpu(), ctx)
    assert cuda_modexp.mont_mul(a[:0], a[:0], ctx).shape == (0, L)


@pytest.mark.parametrize("window", [4, 5])
def test_ladder_kernel_bit_equal_to_plain(dev, window):
    rng = random.Random(window)
    pub, _ = pt.generate_paillier_keypair(n_length=256)
    N = pub.nsquare
    sys_ = rns.build_rns(N, dev)
    Lin = mg.num_limbs_for_modulus(N.bit_length())
    conv = rns.build_conversion(sys_, Lin)
    xs = [rng.randrange(1, 2 * sys_.k * N) for _ in range(19)] + [0, 1]
    x_res = rns.to_rns(_limbs(xs, Lin, dev), conv, sys_).contiguous()
    digits = rns.rns_pow_digits(pub.n, pub.n.bit_length(), window)
    E = rng.randrange(1, N)
    exit_res = rns.residues(E, sys_)
    before = cuda_rns.launches["rns_ladder"]
    got = cuda_rns.ladder(x_res, digits, sys_, window=window,
                          exit_res=exit_res)
    assert cuda_rns.launches["rns_ladder"] == before + 1
    plain = rns.ladder_plain(x_res, digits, sys_, window=window,
                             exit_res=exit_res)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    out = hl.limbs_to_ints(rns.from_rns(got, sys_).cpu().numpy())
    assert [v % N for v in out] == [pow(x, pub.n, N) * E % N for x in xs]


def test_ladder_wrapper_checks(dev):
    pub, _ = pt.generate_paillier_keypair(n_length=128)
    sys_ = rns.build_rns(pub.nsquare, dev)
    x = torch.zeros((3, sys_.cpad), dtype=torch.int64, device=dev)
    digits = rns.rns_pow_digits(pub.n, pub.n.bit_length(), 4)
    with pytest.raises(ValueError, match="2\\^window"):
        cuda_rns.ladder(x, [0, 16], sys_, window=4)
    with pytest.raises(ValueError, match="exit_res"):
        cuda_rns.ladder(x, digits, sys_, window=4,
                        exit_res=sys_.scale.cpu())
    with pytest.raises(TypeError, match="int64"):
        cuda_rns.ladder(x.int(), digits, sys_, window=4)
    on_card = torch.as_tensor(digits, device=dev)
    assert torch.equal(cuda_rns.ladder(x, on_card, sys_, window=4),
                       cuda_rns.ladder(x, digits, sys_, window=4))


def _key(bits):
    if bits == 2048:
        from chip_smoke import P, Q

        pub = pt.PaillierPublicKey(P * Q)
        return pub, pt.PaillierPrivateKey(pub, P, Q)
    return pt.generate_paillier_keypair(n_length=bits)


@pytest.mark.parametrize("bits", [256, 2048])
def test_ladder_vec_kernel_bit_equal_to_plain(dev, bits):
    rng = random.Random(bits)
    pub, _ = _key(bits)
    N = pub.nsquare
    st = pub.device_context(dev).rns_state()
    sys_, L = st.rsys, pub.device_context(dev).L
    rows = 21
    xs = [rng.randrange(1, N) for _ in range(rows - 2)] + [0, 1]
    es = [rng.getrandbits(rng.choice([1, 9, 40, 64])) for _ in range(rows - 3)]
    es += [0, 1, (1 << 64) - 1]
    digits = tbatch._digits_rows(es, 64)
    x_res = rns.to_rns(_limbs(xs, L, dev), st.conv, sys_).contiguous()
    before = cuda_rns.launches["rns_ladder_vec"]
    got = cuda_rns.ladder_vec(x_res, digits, sys_, entry_res=st.entry_mont,
                              exit_res=st.exit_r)
    assert cuda_rns.launches["rns_ladder_vec"] == before + 1
    plain = rns.ladder_vec_plain(x_res, digits, sys_,
                                 entry_res=st.entry_mont, exit_res=st.exit_r)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    R = 1 << (14 * L)
    out = hl.limbs_to_ints(rns.from_rns(got, sys_).cpu().numpy())
    Rinv = pow(R, -1, N)
    assert [v % N for v in out] == [
        pow(x * Rinv, e, N) * R % N for x, e in zip(xs, es)]


@pytest.mark.parametrize("bits", [256, 2048])
@pytest.mark.parametrize("shared", [False, True], ids=["vec", "shared"])
def test_mont_pow_kernels_value_equal_to_plain(dev, bits, shared):
    rng = random.Random(bits + shared)
    pub, _ = _key(bits)
    M = pub.nsquare
    ctx = mg.build_context(M, dev)
    L = ctx.num_limbs
    rows = 9 if shared else 12
    xs = [rng.randrange(0, 2 * M) for _ in range(rows)]
    base = _limbs(xs, L, dev)
    R = 1 << (14 * L)
    Rinv = pow(R, -1, M)
    if shared:
        e, window = pub.n, 5
        digits = torch.as_tensor(mg.exponent_digits(e, e.bit_length(), window),
                                 device=dev)
        es = [e] * rows
        got = cuda_modexp.mont_pow_shared(base, digits, ctx, window=window)
        plain = mg.mont_pow_shared_plain(base, digits, ctx, window=window)
    else:
        window = 4
        es = [rng.getrandbits(320) for _ in range(rows - 2)] + [0, 1]
        digits = tbatch._digits_rows(es, 320)
        got = cuda_modexp.mont_pow(base, digits, ctx)
        plain = mg.mont_pow_plain(base, digits, ctx)
    torch.cuda.synchronize()
    g = hl.limbs_to_ints(got.cpu().numpy())
    want = [pow(x * Rinv, e, M) * R % M for x, e in zip(xs, es)]
    assert [v % M for v in g] == want
    assert [v % M for v in hl.limbs_to_ints(plain.cpu().numpy())] == want
    assert int(got.min()) >= 0 and int(got.max()) <= 1 << 14
    assert all(100 * v < 101 * M for v in g)


def test_new_wrappers_check_their_inputs(dev):
    pub, _ = pt.generate_paillier_keypair(n_length=128)
    dc = pub.device_context(dev)
    st, ctx, L = dc.rns_state(), dc.ctx, dc.L
    x = torch.zeros((3, st.rsys.cpad), dtype=torch.int64, device=dev)
    rows = np.ones((3, 16), np.int8)
    with pytest.raises(ValueError, match="2\\^window"):
        cuda_rns.ladder_vec(x, np.full((3, 16), 16), st.rsys)
    with pytest.raises(ValueError, match="int8"):
        cuda_rns.ladder_vec(x, torch.ones((3, 16), dtype=torch.int64,
                                          device=dev), st.rsys)
    with pytest.raises(ValueError, match="int8"):
        cuda_rns.ladder_vec(x, rows[:2], st.rsys)
    with pytest.raises(TypeError, match="int64"):
        cuda_rns.ladder_vec(x.int(), rows, st.rsys)
    with pytest.raises(ValueError, match="exit_res"):
        cuda_rns.ladder_vec(x, rows, st.rsys, exit_res=st.exit_r.cpu())
    base = torch.zeros((3, L), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="2\\^window"):
        cuda_modexp.mont_pow(base, np.full((3, 4), 17), ctx)
    with pytest.raises(ValueError, match="2\\^window"):
        cuda_modexp.mont_pow_shared(base, [3, 16], ctx)
    with pytest.raises(TypeError, match="int64"):
        cuda_modexp.mont_pow(base.int(), rows, ctx)
    with pytest.raises(ValueError, match="limb count"):
        cuda_modexp.mont_pow(base[:, :-8].contiguous(), rows, ctx)
    with pytest.raises(ValueError, match="is on"):
        cuda_modexp.mont_pow_shared(base, [1], mg.build_context(pub.nsquare,
                                                                "cpu"))
    with pytest.raises(ValueError, match="window"):
        cuda_modexp.mont_pow(base, rows, ctx, window=9)


def test_algebra_on_the_card_goes_through_the_kernels(dev):
    pub, priv = pt.generate_paillier_keypair(n_length=256)
    vals = [1.5, -2.0, 300.0, 0.0625, 1e6]
    other = [2.5e-3, 7.0, -1.0, 4.0, 17]
    scal = [3.0, -0.5, 2.0, -16.0, 1.0]
    a = pt.EncryptedBatch.encrypt(pub, vals, device=dev)
    b = pt.EncryptedBatch.encrypt(pub, other, device=dev)

    def counts(fn):
        for c in (cuda_modexp.launches, cuda_rns.launches):
            for key in c:
                c[key] = 0
        out = fn()
        return out, {k: v for c in (cuda_modexp.launches, cuda_rns.launches)
                     for k, v in c.items() if v}

    got, n = counts(lambda: a + b)
    assert got.decrypt(priv) == [x + y for x, y in zip(vals, other)]
    assert n == {"rns_ladder_vec": 2, "mont_mul": 1}
    got, n = counts(lambda: a * scal)
    assert got.decrypt(priv) == [x * y for x, y in zip(vals, scal)]
    assert n["rns_ladder_vec"] == 1 and n["mont_mul"] >= 1
    X = np.array([[1.0, -2.0, 0.5, 3.0, 1.0], [-1.5, 4.0, -0.25, 2.0, 0.5]])
    got, n = counts(lambda: a.matvec(X))
    assert got.decrypt(priv) == [
        a.mul_scalars([float(v) for v in row]).sum().decrypt(priv)[0]
        for row in X]
    assert n["rns_ladder_vec"] == 1
    got, n = counts(lambda: pt.EncryptedBatch.encrypt(
        pub, vals, obfuscation="short", device=dev))
    assert got.is_obfuscated and got.decrypt(priv) == vals
    assert n["mont_pow"] == 1 and n["mont_mul"] == 1


def test_round_trip_on_the_card_goes_through_the_kernels(dev):
    pub, priv = pt.generate_paillier_keypair(n_length=256)
    values = [0, 1, -1, 3.5, -2.5e-3, 1 << 60, -(1 << 100), 1e6]
    for counts in (cuda_modexp.launches, cuda_rns.launches):
        for key in counts:
            counts[key] = 0
    batch = pt.EncryptedBatch.encrypt(pub, values, device=dev)
    assert batch.mont.is_cuda
    assert batch.decrypt(priv) == values
    assert cuda_rns.launches["rns_ladder"] == 3
    assert cuda_modexp.launches["mont_mul"] == 4
    assert cuda_modexp.launches["mont_mul_const"] == 7
    assert cuda_rns.launches["rns_ladder_vec"] == 0
    rng = random.Random(7)
    rs = [rng.randrange(1, pub.n) for _ in values]
    pinned = pt.EncryptedBatch.encrypt(pub, values, r_values=rs, device=dev)
    encs = pt.EncodedNumber.encode_many(pub, values)
    assert pinned.ciphertext_ints(be_secure=False) == [
        pub.raw_encrypt(e.encoding, r_value=r) for e, r in zip(encs, rs)]
