"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips with a reason where torch.cuda.is_available() is False. The file
imports neither jax nor phe_tpu, so it runs on a machine with only
PyTorch and the CUDA toolkit (the tests' conftest imports jax, hence
--noconftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Montgomery products and the limb-engine modexps are held value-equal mod
M and inside the kernel contract's bounds, from L = 8 limbs (p of a
128-bit key) up to the 8192-bit key's n^2 (L = 1,176 limbs); both ladders
and the issue-rate chain are held bit-equal. Every kernel runs every
width of block its wrapper picks (cuda_rns._elems,
cuda_modexp._pow_elems), reached through the batch size, on ragged
batches. The 3072-bit default key size runs its round trip, pinned-r
encryption and an add on the card. The wire format round-trips a batch on
the card (pinned: raw_encrypt's JSON; secure: re-obfuscated on the card),
crt_powers equals Python's pow at 2048 bits through mont_pow_shared, the
CLI's vector commands run on the card through click's CliRunner, and a
world of one on NCCL sums as batch.sum() does. Each launch takes the
REDC body cuda_modexp._body picks at its shape (the integer pipe for the
8192-bit r^n over 512 rows); the tests of one body hold it through the
launch helpers' private body argument: the integer-pipe bodies run every
block width on ragged batches at L = 80 and 296, and the one-row tile on
thread-block clusters at L = 1,176 on 16 and ragged rows. Both layouts'
shared-memory formulas match the kernels', and the limb engine, reached
with rns.fits made to refuse the key's moduli, gives the RNS engine's
pinned-r ciphertexts at 2048 bits. The transposed matvec of vertical LR
(8,200 ciphertexts, two batch-inversion chunks) decrypts to the plain
reference's exact sums at 2048 bits; the shared-table matvec's select
kernel is bit-equal to its plain version at vfl_credit-2048's grids and
ragged ones, and its matvec gives the ciphertexts of per-element
modexps and a tree on both routes. Tolerance zero throughout: all exact integer arithmetic.
"""

import functools
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import phe_tpu_torch as pt
from phe_tpu_torch import batch as tbatch
from phe_tpu_torch import benchmarks
from phe_tpu_torch.ops import cuda_microbench, cuda_modexp, cuda_rns
from phe_tpu_torch.ops import montgomery as mg
from phe_tpu_torch.ops import rns
from phe_tpu_torch.utils import limbs as hl
from torch_route import refuse_rns

pytestmark = pytest.mark.cuda

# The fixed 3072-bit key (phe_tpu's tests/test_keysize_3072.py P3072,
# Q3072): the default key size, n^2 on the RNS ladder at k = 456.
P3072 = int(
    "0xa6171f4f81623fd7edebe03d88ef260b37747eadb6cecc412070e5a2a40f0cd8"
    "b63504238c7d8c639afc26725946e8967eff131bcf0db2c0102ca7b54ddd9660"
    "bb6f5e25fcefbf5b38bc4bed335570ca5b94986975ca6203f32edf7fd63ecb19"
    "807ab12093cf39ea26d68abd32a73567c6e531cf1ac880cfd0e2dfd357e62de2"
    "ab1561119d576b4dbddf4a606e265132eb571ca5daddf86f11f3db0e0b6716d9"
    "ce154ede4cc800b0adc68bdaffdb64d3cfee638f0874d5d396e3bee74e2a8441",
    16,
)
Q3072 = int(
    "0xfe2ca0e92c536303ebacd2703dc56b367212bdb090142a9405cae071492798b1"
    "c708fb173640794e992065d41d871218599422ae10d26d68842ea5c5eced4f95"
    "efad3acb7e01bace8d0ed1d1030830b14b3c6a68d3d18f2e88252356cb68e183"
    "7ca03fb832166259fa703868b06806d2970b5bdfd1f66728225008ad10ac4275"
    "a95038c9da92208d650ba13243b18906b06fefd2c9306f77921ba144a750847d"
    "b5ef044add2b01d351e6c6b851c8877c9a34df83338de589edd7e2b562e9f3bd",
    16,
)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _limbs(values, L, dev):
    return mg._tensor(hl.ints_to_limbs(values, L), dev)


@pytest.mark.parametrize("bits", [300, 1024, 2048, 4096, 16384])
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
    name = ("mont_mul_const" if shared else "mont_mul") + (
        "" if cuda_modexp._body(L, rows, cuda_rns._sms(dev)) else "_int")
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


@functools.lru_cache(maxsize=None)
def _mul_modulus(which):
    """An odd modulus at each width the products run: p of a 128-bit key
    (L = 8), n^2 of a 256-bit key (40), and the fixed keys' n^2 at 2048
    (296), 3072 (440) and 8192 bits (1,176)."""
    if which == "p128":
        return random.Random(128).getrandbits(64) | 1 << 63 | 1
    if which == "256":
        return _key(256)[0].nsquare
    if which == "3072":
        return (P3072 * Q3072) ** 2
    return benchmarks.fixed_key(int(which))[0].nsquare


@pytest.mark.parametrize("which", ["p128", "256", "2048", "3072", "8192"])
@pytest.mark.parametrize("shared", [False, True], ids=["two", "shared"])
def test_mont_mul_every_width_and_ragged_batch_value_equal(dev, which,
                                                           shared):
    """Both product forms in the int8 body at every (E, rows a block) the
    wrapper picks for it at L = 8, 40, 296, 440 and 1,176, reached through
    the batch size (one row a block of E = 8 on 1, 7, 8 and 9 rows; three
    a block where the matrix stream allows; full blocks of E = 8 and,
    where 32 rows fit, of E = 32, their last block holding 1 row and all
    but one), the body held by the launch's private argument where _body
    would take the integer pipe: every row value-equal to Python ints,
    the first rows and the last two blocks to the plain version, limbs in
    [0, 2^14], values < 1.01 M, one launch counted under the int8 body's
    name."""
    rng = random.Random(len(which) + shared)
    M = _mul_modulus(which)
    ctx = mg.build_context(M, dev)
    L = ctx.num_limbs
    assert L == {"p128": 8, "256": 40, "2048": 296, "3072": 440,
                 "8192": 1176}[which]
    widths = _pow_widths(dev, L)
    rows = max(B for B, _ in widths)
    xs = [rng.randrange(0, 2 * M) for _ in range(rows)]
    ys = [rng.randrange(0, 2 * M) for _ in range(1 if shared else rows)]
    a, b = _limbs(xs, L, dev), _limbs(ys, L, dev)
    R_inv = pow(1 << (14 * L), -1, M)
    name = "mont_mul_const" if shared else "mont_mul"
    fn = functools.partial(cuda_modexp._launch, ctx=ctx, shared=shared,
                           body=True)
    for B, (E, per, C) in widths:
        assert cuda_modexp._pow_elems(L, B, cuda_rns._sms(dev)) == (E, per, C)
        bb = b[0] if shared else b[:B].contiguous()
        before = cuda_modexp.launches[name]
        got = fn(a[:B].contiguous(), bb)
        assert cuda_modexp.launches[name] == before + 1
        idx = sorted(set(range(min(B, 4)))
                     | set(range(max(0, B - 2 * per), B)))
        ref = cuda_modexp.mont_mul_plain(a[idx], bb if shared else bb[idx],
                                         ctx)
        torch.cuda.synchronize()
        g = hl.limbs_to_ints(got.cpu().numpy())
        want = [x * (ys[0] if shared else y) * R_inv % M
                for x, y in zip(xs[:B], ys * B if shared else ys[:B])]
        assert [v % M for v in g] == want, (B, E, per)
        assert [v % M for v in hl.limbs_to_ints(ref.cpu().numpy())] == [
            want[i] for i in idx]
        assert int(got.min()) >= 0 and int(got.max()) <= 1 << 14
        assert all(100 * v < 101 * M for v in g)


def test_mont_mul_smem_formula_matches_the_kernel(dev):
    """Both layouts: the int8 body's (mxu) and the integer pipe's."""
    cuda_modexp._lib(False, 8)
    lib = cuda_modexp._build.load("mont_mul")
    for L in (8, 16, 24, 40, 80, 152, 296, 440, 592, 1176,
              cuda_modexp.MAX_MUL_LIMBS):
        for E in cuda_modexp.INT_ELEMS:
            for mxu in (True, False)[E == 1:]:
                assert (lib.phe_mont_mul_smem(L, E, int(mxu))
                        == cuda_modexp._pow_smem(L, E, mxu))


def test_3072_bit_default_key_on_the_card(dev):
    """The default key size (keys.DEFAULT_KEYSIZE): a round trip through
    the kernels, pinned-r ciphertexts equal to the host's raw_encrypt,
    and one add. n^2 runs on the ladder at k = 456 (E = 32 at a full
    16,384-row call) and the products at L = 440 in blocks of E = 8."""
    from phe_tpu_torch.keys import DEFAULT_KEYSIZE

    pub = pt.PaillierPublicKey(P3072 * Q3072)
    priv = pt.PaillierPrivateKey(pub, P3072, Q3072)
    assert pub.n.bit_length() == DEFAULT_KEYSIZE == 3072
    dc = pub.device_context(dev)
    assert dc.L == 440 and dc.rns_state().rsys.k == 456
    sms = cuda_rns._sms(dev)
    assert cuda_rns._elems(456, 16384, sms) == 32
    assert cuda_modexp._pow_elems(440, 16384, sms) == (8, 8, 1)
    values = [0, 1, -1, 3.5, -2.5e-3, 1 << 60, -(1 << 100), 1e6, 17, -0.125]
    for counts in (cuda_modexp.launches, cuda_rns.launches):
        for key in counts:
            counts[key] = 0
    batch = pt.EncryptedBatch.encrypt(pub, values, device=dev)
    assert batch.mont.is_cuda
    assert batch.decrypt(priv) == values
    assert cuda_rns.launches["rns_ladder"] == 3
    assert _by_form(cuda_modexp.launches)["mont_mul"] == 4
    assert _by_form(cuda_modexp.launches)["mont_mul_const"] == 7
    rng = random.Random(3072)
    rs = [rng.randrange(1, pub.n) for _ in values]
    pinned = pt.EncryptedBatch.encrypt(pub, values, r_values=rs, device=dev)
    encs = pt.EncodedNumber.encode_many(pub, values)
    assert pinned.ciphertext_ints(be_secure=False) == [
        pub.raw_encrypt(e.encoding, r_value=r) for e, r in zip(encs, rs)]
    vals = [1.5, -2.0, 300.0, 0.0625, 1e6]
    other = [2.5e-3, 7.0, -1.0, 4.0, 17]
    a = pt.EncryptedBatch.encrypt(pub, vals, device=dev)
    b = pt.EncryptedBatch.encrypt(pub, other, device=dev)
    for counts in (cuda_modexp.launches, cuda_rns.launches):
        for key in counts:
            counts[key] = 0
    total = a + b
    assert _by_form(_counts()) == {"rns_ladder_vec": 2, "mont_mul": 1}
    assert total.decrypt(priv) == [x + y for x, y in zip(vals, other)]


def test_3072_bit_full_call_takes_32_element_blocks(dev):
    """A 16,384-row encrypt at the fixed 3072-bit key runs its r^n ladder
    (k = 456) in one launch, whose width _elems gives as blocks of 32
    elements; the decrypt's two CRT halves take E = 32 too, in two
    launches, and the batch decrypts to its values."""
    pub, priv = benchmarks.fixed_key(3072)
    g = np.random.default_rng(3072)
    values = [float(v) for v in g.uniform(-1e6, 1e6, 16384)]
    sms = cuda_rns._sms(dev)
    for key in cuda_rns.launches:
        cuda_rns.launches[key] = 0
    batch = pt.EncryptedBatch.encrypt(pub, values, device=dev)
    st = pub.device_context(dev).rns_state()
    assert st.rsys.k == 456 and cuda_rns._elems(st.rsys.k, 16384, sms) == 32
    assert cuda_rns.launches == {"rns_ladder": 1, "rns_ladder_vec": 0}
    assert batch.decrypt(priv) == values
    halves = priv.device_context(dev).rns_state()
    assert all(cuda_rns._elems(h[0].k, 16384, sms) == 32 for h in halves)
    assert cuda_rns.launches == {"rns_ladder": 3, "rns_ladder_vec": 0}


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
        return benchmarks.fixed_key(2048)
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
        return out, _by_form(_counts())

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
    assert n["table_select"] == 1 and "rns_ladder_vec" not in n
    got, n = counts(lambda: pt.EncryptedBatch.encrypt(
        pub, vals, obfuscation="short", device=dev))
    assert got.is_obfuscated and got.decrypt(priv) == vals
    assert n["mont_pow"] == 1 and n["mont_mul"] == 1


def test_transposed_matvec_at_2048_bits_over_two_inverse_chunks(dev):
    """X^T [[d]] as hetero LR forms it (models/hetero_lr.py): 8,200
    ciphertexts, whose 16,384-row bucket takes two batch-inversion
    chunks, against 3 feature rows of mixed sign on the fixed 2048-bit
    key; the decrypted sums equal the plain reference's exact ones."""
    from paillier_bench.reference import paillier as ref

    pub, priv = benchmarks.fixed_key(2048)
    rng = np.random.default_rng(25)
    rows = 8200
    d = rng.normal(0.0, 0.3, rows)
    X = rng.normal(0.0, 1.0, (rows, 3))
    batch = pt.EncryptedBatch.encrypt(pub, d.tolist(), device=dev)
    assert batch.mont.shape[0] == 2 * batch._INVERSE_CHUNK
    got = batch.matvec(X.T)
    mv, ev = ref.encode_array(d)
    mx, ex = ref.encode_array(X)
    totals = ref.aligned_sums(mv.astype(object)[:, None] * mx,
                              ev[:, None] + ex)
    exps = (ev[:, None] + ex).min(axis=0)
    assert got.exponents.tolist() == exps.tolist()
    assert got.decrypt(priv) == [ref.decode(t, int(e))
                                 for t, e in zip(totals, exps)]


@pytest.mark.parametrize("shape", [
    (13, 30000, 24, 2, 296), (11, 30000, 24, 2, 296), (13, 30000, 24, 1, 296),
    (3, 37, 8, 2, 80), (1, 1, 1, 1, 296), (5, 257, 33, 2, 296),
    (600, 21, 16, 2, 296), (2, 9, 8, 2, 1176)],
    ids=lambda s: "B%d-D%d-W%d-s%d-L%d" % s)
def test_table_select_kernel_equals_plain(dev, shape):
    """The shared-table matvec's select kernel bit-equal to its plain
    version at the main path's shapes (vfl_credit-2048's grids: 30,000
    bases, 13 and 11 rows, 24 windows, both signs, L = 296, over the
    chunks of bases batch._matvec takes) and at ragged ones, one
    launch a chunk."""
    B, D, W, signs, L = shape
    g = torch.Generator(device=dev)
    g.manual_seed(B * 100003 + D)
    table = torch.randint(0, (1 << 14) + 1, (16, signs, D, L),
                          dtype=torch.int64, device=dev, generator=g)
    digits = torch.randint(0, 16, (B, D, W), dtype=torch.int8, device=dev,
                           generator=g)
    neg = torch.rand((B, D), device=dev, generator=g) < 0.5
    step = tbatch._select_bases(B, D, W, L)
    before = cuda_modexp.launches["table_select"]
    for i0 in range(0, D, step):
        dc = min(step, D - i0)
        got = cuda_modexp.table_select(table, digits, neg, i0, dc)
        want = cuda_modexp.table_select_plain(table, digits, neg, i0, dc)
        assert torch.equal(got, want)
        del got, want
    assert cuda_modexp.launches["table_select"] == before + -(-D // step)


@pytest.mark.parametrize("route", ["rns", "limb"])
def test_shared_table_matvec_at_2048_bits(dev, monkeypatch, route):
    """X^T [[d]] for 3,000 residuals against 13 features at 2048 bits
    takes the shared table (a table_select launch, no per-element modexp)
    and gives the ciphertexts of a modexp a grid element and a tree
    (batch._pow_elems, batch._tree_fold) mod n^2 on either route, and the
    plain reference's exact sums."""
    from paillier_bench.reference import paillier as ref

    if route == "limb":
        refuse_rns(monkeypatch)
    pub, priv = benchmarks.fixed_key(2048)
    rng = np.random.default_rng(26)
    rows = 3000
    d = rng.normal(0.0, 0.3, rows)
    X = rng.normal(0.0, 1.0, (rows, 13))
    batch = pt.EncryptedBatch.encrypt(pub, d.tolist(), device=dev)
    inv = batch.inverse_mont()
    for c in (cuda_modexp.launches, cuda_rns.launches):
        for key in c:
            c[key] = 0
    got = batch.matvec(X.T)
    n = _by_form(_counts())
    assert n["table_select"] == 1 and "rns_ladder_vec" not in n
    assert "mont_pow" not in n
    dc = batch._dc
    assert (dc.rns_state() is None) == (route == "limb")
    digits, neg, _ = batch._grid(X.T)
    grid = (13, rows, dc.L)
    base = torch.where(torch.as_tensor(neg).to(dev)[..., None],
                       inv[:rows].expand(grid), batch.mont[:rows].expand(grid))
    powed = tbatch._pow_elems(base, tbatch._digits_on(digits, dev), dc.ctx,
                              dc.rns_state())
    per = tbatch._tree_fold(powed.transpose(0, 1), dc.ctx)[0]
    nsq = pub.nsquare
    ints = lambda m: [v % nsq for v in hl.limbs_to_ints(m.cpu().numpy())]
    assert ints(got.mont) == ints(per)
    mv, ev = ref.encode_array(d)
    mx, ex = ref.encode_array(X)
    totals = ref.aligned_sums(mv.astype(object)[:, None] * mx,
                              ev[:, None] + ex)
    exps = (ev[:, None] + ex).min(axis=0)
    assert got.decrypt(priv) == [ref.decode(t, int(e))
                                 for t, e in zip(totals, exps)]


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
    assert _by_form(cuda_modexp.launches)["mont_mul"] == 4
    assert _by_form(cuda_modexp.launches)["mont_mul_const"] == 7
    assert cuda_rns.launches["rns_ladder_vec"] == 0
    rng = random.Random(7)
    rs = [rng.randrange(1, pub.n) for _ in values]
    pinned = pt.EncryptedBatch.encrypt(pub, values, r_values=rs, device=dev)
    encs = pt.EncodedNumber.encode_many(pub, values)
    assert pinned.ciphertext_ints(be_secure=False) == [
        pub.raw_encrypt(e.encoding, r_value=r) for e, r in zip(encs, rs)]


@pytest.mark.parametrize("body", sorted(cuda_microbench.BODIES))
def test_issue_chain_kernel_bit_equal_to_plain(dev, body):
    rng = np.random.default_rng(len(body))
    x = torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, (256, 512),
                                     dtype=np.int64).astype(np.int32),
                        device=dev)
    for K in (0, 1, 37):
        before = cuda_microbench.launches["vpu_microbench"]
        got = cuda_microbench.issue_chain(x, body, K)
        assert cuda_microbench.launches["vpu_microbench"] == before + 1
        plain = cuda_microbench.issue_chain_plain(x, body, K)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, plain)


def test_issue_chain_wrapper_checks(dev):
    x = torch.ones((4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int32"):
        cuda_microbench.issue_chain(x.long(), "mul", 3)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_microbench.issue_chain(x.t(), "mul", 3)
    with pytest.raises(ValueError, match="\\[R, C\\]"):
        cuda_microbench.issue_chain(x.reshape(-1), "mul", 3)
    with pytest.raises(ValueError, match="unknown body"):
        cuda_microbench.issue_chain(x, "dp4a", 3)
    assert cuda_microbench.issue_chain(x[:0], "add", 3).shape == (0, 8)


def test_mont_pow_at_the_8192_bit_geometry(dev):
    """mont_pow's int8 body at L = 1,176 (n^2 of an 8192-bit key, window
    4: blocks of E = 8 in 227,072 bytes of shared memory, the table in
    device memory), held by the launch's private body argument, on 64-bit
    schedules, against its plain version and Python pow."""
    rng = random.Random(8192)
    M = rng.getrandbits(16384) | (1 << 16383) | 1
    ctx = mg.build_context(M, dev)
    L = ctx.num_limbs
    assert L == 1176
    rows = 6
    xs = [rng.randrange(0, 2 * M) for _ in range(rows)]
    es = [rng.getrandbits(64) for _ in range(rows - 2)] + [0, (1 << 64) - 1]
    base = _limbs(xs, L, dev)
    digits = tbatch._digits_rows(es, 64)
    before = cuda_modexp.launches["mont_pow"]
    got = cuda_modexp._pow_launch(base, digits, ctx, mg.DEFAULT_WINDOW,
                                  vec=True, body=True)
    assert cuda_modexp.launches["mont_pow"] == before + 1
    plain = mg.mont_pow_plain(base, digits, ctx)
    torch.cuda.synchronize()
    R = 1 << (14 * L)
    Rinv = pow(R, -1, M)
    want = [pow(x * Rinv, e, M) * R % M for x, e in zip(xs, es)]
    g = hl.limbs_to_ints(got.cpu().numpy())
    assert [v % M for v in g] == want
    assert [v % M for v in hl.limbs_to_ints(plain.cpu().numpy())] == want
    assert int(got.min()) >= 0 and int(got.max()) <= 1 << 14
    assert all(100 * v < 101 * M for v in g)


def test_8192_bit_r_n_takes_the_integer_pipe_and_int8_stays_held(dev):
    """The 8192-bit key's n^2 with REDC matrices (L = 1,176): the
    encrypt's r^n launch shape, mont_pow_shared over 512 rows (a 256-bit
    exponent at ENCRYPT_WINDOW), runs the integer pipe (counted under
    mont_pow_shared_int, not mont_pow_shared) and is value-equal mod M to
    mont_pow_shared_plain and to Python's pow on four rows; the int8
    body, held by the launch's private body argument, gives the same
    values mod M on every row and counts under its own name."""
    M = benchmarks.fixed_key(8192)[0].nsquare
    ctx = mg.build_context(M, dev)
    L = ctx.num_limbs
    assert L == 1176
    assert not cuda_modexp._body(L, 512, cuda_rns._sms(dev))
    rng = random.Random(1176 + 512)
    xs = [rng.randrange(0, 2 * M) for _ in range(512)]
    base = _limbs(xs, L, dev)
    e = rng.getrandbits(256) | 1 << 255
    window = tbatch.ENCRYPT_WINDOW
    digits = torch.as_tensor(mg.exponent_digits(e, 256, window), device=dev)
    before = dict(cuda_modexp.launches)
    got = cuda_modexp.mont_pow_shared(base, digits, ctx, window=window)
    assert cuda_modexp.launches["mont_pow_shared_int"] == (
        before["mont_pow_shared_int"] + 1)
    assert cuda_modexp.launches["mont_pow_shared"] == before["mont_pow_shared"]
    held = cuda_modexp._pow_launch(base, digits, ctx, window, vec=False,
                                   body=True)
    assert cuda_modexp.launches["mont_pow_shared"] == (
        before["mont_pow_shared"] + 1)
    idx = [0, 1, 510, 511]
    plain = mg.mont_pow_shared_plain(base[idx], digits, ctx, window=window)
    torch.cuda.synchronize()
    assert torch.equal(mg.export_canonical(got, ctx),
                       mg.export_canonical(held, ctx))
    assert torch.equal(mg.export_canonical(got[idx], ctx),
                       mg.export_canonical(plain, ctx))
    R = 1 << (14 * L)
    Rinv = pow(R, -1, M)
    g = hl.limbs_to_ints(got.cpu().numpy())
    assert [g[i] % M for i in idx] == [pow(xs[i] * Rinv, e, M) * R % M
                                        for i in idx]
    assert int(got.min()) >= 0 and int(got.max()) <= 1 << 14
    assert all(100 * v < 101 * M for v in g)


def _pow_widths(dev, L, mxu=True):
    """(B, (E, rows a block, C)): batches of 1, 7, 8 and 9 rows at one row
    a block of E = 8 (the integer pipe: the one-row tile on 1, 7, 8, 9,
    16, 20, 40 and sms - 1 rows, its clusters of 8, 4, 2 and 1 blocks, as
    many as the card holds at once, among them);
    at three rows a block of E = 8 (where, with mxu, their matrix stream
    allows it), at full blocks of E = 8 and, where a block of 32 rows fits
    the body's layout, of E = 32, the smallest and largest batches that
    take it on this card, their last block holding 1 row and all but
    one."""
    sms = cuda_rns._sms(dev)
    if mxu:
        out = [(B, (8, 1, 1)) for B in (1, 7, 8, 9)]
    else:
        out = [(B, cuda_modexp._tile(L, B, dev, False, "mont_pow")[:3])
               for B in (1, 7, 8, 9, 16, 20, 40, sms - 1)]
        assert {C for _, (E, _, C) in out} == {1, 2, 4, 8}
    if not mxu or (3 * sms - 1) * 12 * L * L <= 3 * cuda_modexp.POW_STREAM:
        out += [(2 * sms + 1, (8, 3, 1)), (3 * sms - 1, (8, 3, 1))]
    for E in (8, 32):
        if cuda_modexp._pow_smem(L, E, mxu) <= cuda_modexp.MAX_SMEM:
            out += [((sms - 1) * E + 1, (E, E, 1)), (sms * E - 1, (E, E, 1))]
    return out


@pytest.mark.parametrize("which", ["256", "2048", "8192"])
@pytest.mark.parametrize("vec", [False, True], ids=["shared", "vec"])
def test_mont_pow_every_width_and_ragged_batch_value_equal(dev, which, vec):
    """Both modexp forms in the int8 body at every (E, rows a block) the
    wrapper picks for it, reached through the batch size, at L = 40, 296
    and 1,176 (64-bit exponents, window 4), the body held by the launch's
    private argument where _body would take the integer pipe:
    value-equal to the plain version and Python pow on the first rows and
    the last two blocks, limbs in [0, 2^14], value < 1.01 M, one launch
    counted under the int8 body's name."""
    rng = random.Random(len(which) + vec)
    if which == "256":
        M = _key(256)[0].nsquare
    else:
        M = benchmarks.fixed_key(int(which))[0].nsquare
    ctx = mg.build_context(M, dev)
    L = ctx.num_limbs
    widths = _pow_widths(dev, L)
    rows = max(B for B, _ in widths)
    xs = [rng.randrange(0, 2 * M) for _ in range(rows)]
    base = _limbs(xs, L, dev)
    R = 1 << (14 * L)
    Rinv = pow(R, -1, M)
    if vec:
        es = [(0, (1 << 64) - 1)[i % 2] if i < 4 else rng.getrandbits(64)
              for i in range(rows)]
        digits = torch.as_tensor(tbatch._digits_rows(es, 64), device=dev)
    else:
        e = rng.getrandbits(64) | 1 << 63
        es = [e] * rows
        digits = torch.as_tensor(mg.exponent_digits(e, 64), device=dev)
    name = "mont_pow" if vec else "mont_pow_shared"
    fn = functools.partial(cuda_modexp._pow_launch, ctx=ctx,
                           window=mg.DEFAULT_WINDOW, vec=vec, body=True)
    plain = mg.mont_pow_plain if vec else mg.mont_pow_shared_plain
    for B, (E, per, C) in widths:
        assert cuda_modexp._pow_elems(L, B, cuda_rns._sms(dev)) == (E, per, C)
        before = cuda_modexp.launches[name]
        db = digits[:B].contiguous() if vec else digits
        got = fn(base[:B].contiguous(), db)
        assert cuda_modexp.launches[name] == before + 1
        idx = sorted(set(range(min(B, 4)))
                     | set(range(max(0, B - 2 * per), B)))
        ref = plain(base[idx], digits[idx] if vec else digits, ctx)
        torch.cuda.synchronize()
        g = hl.limbs_to_ints(got[idx].cpu().numpy())
        want = [pow(xs[i] * Rinv, es[i], M) * R % M for i in idx]
        assert [v % M for v in g] == want, (B, E, per)
        assert [v % M for v in hl.limbs_to_ints(ref.cpu().numpy())] == want
        assert int(got.min()) >= 0 and int(got.max()) <= 1 << 14
        assert all(100 * v < 101 * M
                   for v in hl.limbs_to_ints(got.cpu().numpy()))


def test_pow_smem_formula_matches_the_kernel(dev):
    """Both layouts: the int8 body's (mxu) and the integer pipe's."""
    cuda_modexp._pow_lib(False, 8)
    lib = cuda_modexp._build.load("mont_pow")
    for L in (16, 24, 40, 152, 296, 304, 592, 1176):
        for E in cuda_modexp.INT_ELEMS:
            for mxu in (True, False)[E == 1:]:
                assert (lib.phe_mont_pow_smem(L, E, int(mxu))
                        == cuda_modexp._pow_smem(L, E, mxu))


@pytest.mark.parametrize("which", ["p", "n2"])
@pytest.mark.parametrize("form", ["mul", "mul_const", "pow_shared", "pow"])
def test_integer_pipe_bodies_value_equal_on_ragged_batches(dev, which, form):
    """Each integer-pipe REDC body (held by the launch helpers' private
    body argument) at the fixed 2048-bit key's p (L = 80) and n^2
    (L = 296), at every (E, rows a block) the wrapper picks, reached
    through the batch size: value-equal to the plain version (every row
    of a product; the first rows and the last two blocks of a modexp,
    64-bit exponents, window 4) and to Python's pow, limbs in [0, 2^14],
    value < 1.01 M, and counted under its own name."""
    pub, priv = benchmarks.fixed_key(2048)
    M = priv.p if which == "p" else pub.nsquare
    ctx = mg.build_context(M, dev)
    L = ctx.num_limbs
    assert L == {"p": 80, "n2": 296}[which]
    rng = random.Random(L + len(form))
    widths = _pow_widths(dev, L, mxu=False)
    rows = max(B for B, _ in widths)
    xs = [rng.randrange(0, 2 * M) for _ in range(rows)]
    ys = [rng.randrange(0, 2 * M) for _ in range(rows)]
    a, b = _limbs(xs, L, dev), _limbs(ys, L, dev)
    R = 1 << (14 * L)
    Rinv = pow(R, -1, M)
    e = rng.getrandbits(64) | 1 << 63
    es = ([(0, (1 << 64) - 1)[i % 2] if i < 4 else rng.getrandbits(64)
           for i in range(rows)] if form == "pow" else [e] * rows)
    digits = torch.as_tensor(tbatch._digits_rows(es, 64) if form == "pow"
                             else mg.exponent_digits(e, 64), device=dev)
    name = "mont_" + form + "_int"
    for B, (E, per, C) in widths:
        assert cuda_modexp._tile(L, B, dev, False,
                                 "mont_pow")[:3] == (E, per, C)
        x, y = a[:B].contiguous(), b[:B].contiguous()
        before = cuda_modexp.launches[name]
        if form.startswith("mul"):
            shared = form == "mul_const"
            got = cuda_modexp._launch(x, y[0] if shared else y, ctx, shared,
                                      body=False)
            ref = cuda_modexp.mont_mul_plain(x, y[0] if shared else y, ctx)
            idx = list(range(B))
            want = [xs[i] * ys[0 if shared else i] * Rinv % M for i in idx]
        else:
            d = digits[:B].contiguous() if form == "pow" else digits
            got = cuda_modexp._pow_launch(x, d, ctx, mg.DEFAULT_WINDOW,
                                          form == "pow", body=False)
            idx = sorted(set(range(min(B, 4)))
                         | set(range(max(0, B - 2 * per), B)))
            ref = (mg.mont_pow_plain(x[idx], digits[idx], ctx) if form == "pow"
                   else mg.mont_pow_shared_plain(x[idx], digits, ctx))
            want = [pow(xs[i] * Rinv, es[i], M) * R % M for i in idx]
        assert cuda_modexp.launches[name] == before + 1
        torch.cuda.synchronize()
        g = hl.limbs_to_ints(got.cpu().numpy())
        assert [g[i] % M for i in idx] == want, (B, E, per)
        assert [v % M for v in hl.limbs_to_ints(ref.cpu().numpy())] == want
        assert int(got.min()) >= 0 and int(got.max()) <= 1 << 14
        assert all(100 * v < 101 * M for v in g)


@pytest.mark.parametrize("form", ["mul", "mul_const", "pow_shared", "pow"])
def test_cluster_tile_value_equal_at_1176_on_16_and_ragged_rows(dev, form):
    """The integer-pipe body's one-row tile at the 8192-bit key's n^2
    (L = 1,176, held by the launch helpers' private body argument) on 16
    rows (one row a cluster of 4 blocks on an H100, which holds 15
    clusters of 8 at once) and on ragged batches of 1, 7 and 131 rows
    (clusters of 8, 8 and 1), each batch in one wave of clusters: every
    row value-equal to the plain version (a modexp's first and last two
    rows, 64-bit exponents, window 4) and to Python's pow, limbs in
    [0, 2^14], value < 1.01 M, one launch counted under the body's
    name."""
    M = benchmarks.fixed_key(8192)[0].nsquare
    ctx = mg.build_context(M, dev)
    assert ctx.num_limbs == 1176
    L = ctx.num_limbs
    sms = cuda_rns._sms(dev)
    rng = random.Random(1176 + len(form))
    xs = [rng.randrange(0, 2 * M) for _ in range(131)]
    ys = [rng.randrange(0, 2 * M) for _ in range(131)]
    a, b = _limbs(xs, L, dev), _limbs(ys, L, dev)
    R = 1 << (14 * L)
    Rinv = pow(R, -1, M)
    e = rng.getrandbits(64) | 1 << 63
    es = ([(0, (1 << 64) - 1)[i % 2] if i < 4 else rng.getrandbits(64)
           for i in range(131)] if form == "pow" else [e] * 131)
    digits = torch.as_tensor(tbatch._digits_rows(es, 64) if form == "pow"
                             else mg.exponent_digits(e, 64), device=dev)
    name = "mont_" + form + "_int"
    fit = cuda_modexp._fit("mont_pow", dev, L)
    for B in (16, 1, 7, 131):
        _, _, C = cuda_modexp._pow_elems(L, B, sms, False, fit)
        assert B <= fit(C) and B * C <= sms and (B < 16 or C < 8 or
                                                 fit(8) >= 16)
        x, y = a[:B].contiguous(), b[:B].contiguous()
        before = cuda_modexp.launches[name]
        if form.startswith("mul"):
            shared = form == "mul_const"
            got = cuda_modexp._launch(x, y[0] if shared else y, ctx, shared,
                                      body=False)
            idx = list(range(B))
            ref = cuda_modexp.mont_mul_plain(x, y[0] if shared else y, ctx)
            want = [xs[i] * ys[0 if shared else i] * Rinv % M for i in idx]
        else:
            d = digits[:B].contiguous() if form == "pow" else digits
            got = cuda_modexp._pow_launch(x, d, ctx, mg.DEFAULT_WINDOW,
                                          form == "pow", body=False)
            idx = sorted({0, B - 2, B - 1} - {-1})
            ref = (mg.mont_pow_plain(x[idx], digits[idx], ctx) if form == "pow"
                   else mg.mont_pow_shared_plain(x[idx], digits, ctx))
            want = [pow(xs[i] * Rinv, es[i], M) * R % M for i in idx]
        assert cuda_modexp.launches[name] == before + 1
        torch.cuda.synchronize()
        g = hl.limbs_to_ints(got.cpu().numpy())
        assert [g[i] % M for i in idx] == want, (form, B, C)
        assert [v % M for v in hl.limbs_to_ints(ref.cpu().numpy())] == want
        assert int(got.min()) >= 0 and int(got.max()) <= 1 << 14
        assert all(100 * v < 101 * M for v in g)


def test_limb_engine_at_2048_bits_equals_the_rns_engine(dev, monkeypatch):
    """The limb engine at the fixed 2048-bit key, 64 rows, reached with
    rns.fits made to refuse every modulus for a new key object: its
    pinned-r ciphertexts equal the RNS engine's and raw_encrypt's, its
    round trip returns x, and no ladder runs."""
    pub, priv = benchmarks.fixed_key(2048)
    rng = random.Random(2048)
    values = [rng.uniform(-1e6, 1e6) for _ in range(64)]
    rs = [rng.randrange(1, pub.n) for _ in values]
    ints = {}
    for engine in ("limb", "rns"):
        pub, priv = benchmarks.fixed_key(2048)
        with monkeypatch.context() as m:
            if engine == "limb":
                refuse_rns(m)
            for counts in (cuda_modexp.launches, cuda_rns.launches):
                for key in counts:
                    counts[key] = 0
            batch = pt.EncryptedBatch.encrypt(pub, values, r_values=rs,
                                              device=dev)
            ints[engine] = batch.ciphertext_ints(be_secure=False)
            assert batch.decrypt(priv) == values
        assert (pub.device_context(dev).rns_state() is None) == (
            engine == "limb")
        ladders = cuda_rns.launches["rns_ladder"]
        assert (ladders == 0) == (engine == "limb")
        assert (_by_form(cuda_modexp.launches).get("mont_pow_shared")
                == 3) == (engine == "limb")
    encs = pt.EncodedNumber.encode_many(pub, values)
    assert ints["limb"] == ints["rns"] == [
        pub.raw_encrypt(e.encoding, r_value=r) for e, r in zip(encs, rs)]


@functools.lru_cache(maxsize=None)
def _rns_geometry(which):
    """(M, RNSSystem on the card, input limbs, conversion) of the 256-bit
    test key's n^2, or the fixed 2048-bit key's p^2 (k = 152) or n^2
    (k = 304), the fixed 3072-bit key's n^2 (k = 456), or the fixed
    8192-bit key's p^2 (k = 624)."""
    dev = torch.device("cuda")
    if which == "256":
        M = pt.generate_paillier_keypair(n_length=256)[0].nsquare
    else:
        bits = {"p2_8192": 8192, "n2_3072": 3072}.get(which, 2048)
        pub, priv = benchmarks.fixed_key(bits)
        M = pub.nsquare if which.startswith("n2") else priv.psquare
    sys_ = rns.build_rns(M, dev)
    Lin = mg.num_limbs_for_modulus(M.bit_length())
    return M, sys_, Lin, rns.build_conversion(sys_, Lin)


def _widths(dev):
    """(B, E): batches of 1, E - 1, E, E + 1 and 21 rows at E = 8, and at
    E = 32 the smallest batches that take that width on this card with
    their last block holding 1, E - 1 and E elements, and a batch of an
    odd count of blocks, whose last cluster of two holds a spare block."""
    sms = cuda_rns._sms(dev)
    odd = (sms | 1) + 2
    return [(B, 8) for B in (1, 7, 8, 9, 21)] + [
        ((sms - 1) * 32 + 1, 32), (sms * 32 - 1, 32), (sms * 32, 32),
        (odd * 32 - 5, 32)]


def _ladder_inputs(which, vec, rows, dev):
    """Residues of values < M and, with vec, 64-bit schedules whose first
    rows alternate all-zero and all-(2^w - 1) digits; else one schedule."""
    M, sys_, Lin, conv = _rns_geometry(which)
    rng = random.Random(sys_.k + vec)
    xs = [rng.randrange(0, M) for _ in range(rows)]
    x = rns.to_rns(_limbs(xs, Lin, dev), conv, sys_).contiguous()
    if vec:
        es = [(0, (1 << 64) - 1)[i % 2] if i < 4 else rng.getrandbits(64)
              for i in range(rows)]
        digits = torch.as_tensor(tbatch._digits_rows(es, 64), device=dev)
    else:
        digits = rns.rns_pow_digits(rng.getrandbits(64) | 1 << 63, 64, 4)
    return sys_, x, digits


def _ladder_check(sys_, x, digits, vec, B, E):
    """Kernel on B rows against the plain version on the first rows and
    the last two blocks."""
    assert cuda_rns._elems(sys_.k, B, cuda_rns._sms(x.device)) == E
    name = "rns_ladder_vec" if vec else "rns_ladder"
    xb = x[:B].contiguous()
    before = cuda_rns.launches[name]
    if vec:
        db = digits[:B].contiguous()
        got = cuda_rns.ladder_vec(xb, db, sys_)
    else:
        got = cuda_rns.ladder(xb, digits, sys_, window=4)
    assert cuda_rns.launches[name] == before + 1
    rows = sorted(set(range(min(B, 4))) | set(range(max(0, B - E - 1), B)))
    if vec:
        plain = rns.ladder_vec_plain(xb[rows], db[rows], sys_)
    else:
        plain = rns.ladder_plain(xb[rows], digits, sys_, window=4)
    torch.cuda.synchronize()
    assert torch.equal(got[rows], plain), (B, E)


@pytest.mark.parametrize("which", ["256", "p2", "n2", "n2_3072"])
@pytest.mark.parametrize("vec", [False, True], ids=["shared", "vec"])
def test_ladder_every_width_and_ragged_batch_bit_equal(dev, which, vec):
    widths = _widths(dev)
    sys_, x, digits = _ladder_inputs(which, vec, max(B for B, _ in widths),
                                     dev)
    for B, E in widths:
        _ladder_check(sys_, x, digits, vec, B, E)


@pytest.mark.parametrize("vec", [False, True], ids=["shared", "vec"])
def test_ladder_at_k_624(dev, vec):
    """The 8192-bit key's p^2 (k = 624): 111,872 bytes a block at E = 8
    (two stages of two K-steps of a whole round) and 232,448 at E = 32
    (two stages of one K-step: all a block may have), bit-equal at both
    on ragged batches, an odd count of blocks among them; and at k = 720,
    past the channel supply, where 32 elements would take 263,168 bytes,
    that width raises before any launch."""
    sms = cuda_rns._sms(dev)
    odd = (sms | 1) + 2
    sys_, x, digits = _ladder_inputs("p2_8192", vec, odd * 32, dev)
    assert sys_.k == 624 and cuda_rns._ring(624, 32) == (1, 2)
    for B, E in ((9, 8), ((sms - 1) * 32 + 1, 32), (sms * 32, 32),
                 (odd * 32 - 3, 32)):
        _ladder_check(sys_, x, digits, vec, B, E)
    k = 720
    C = 2 * k + 8
    zero = torch.zeros(C, dtype=torch.int64, device=dev)
    wide = SimpleNamespace(
        k=k, cpad=C, mbinv_r=zero[:1], w_ext1=zero, w_ext2=zero,
        r2_dom=zero, scale=zero, **{f: zero for f in cuda_rns._ROWS})
    xw = torch.zeros((1, C), dtype=torch.int64, device=dev)
    dw = (torch.zeros((1, 16), dtype=torch.int8, device=dev) if vec
          else torch.zeros(16, dtype=torch.int64, device=dev))
    counts = dict(cuda_rns.launches)
    assert cuda_rns._smem(k, 32) == 263168 > cuda_rns.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        cuda_rns._launch(xw, dw, wide, 4, None, None, vec, 32)
    assert cuda_rns.launches == counts


def test_ladder_smem_formula_matches_the_kernel(dev):
    """The kernel's shared memory, ring included, is _smem's at every k."""
    cuda_rns._lib(False, 8)
    lib = cuda_rns._build.load("rns_ladder")
    for k in (8, 40, 152, 176, 304, 392, 456, 624, 664, 667, 720):
        for E in cuda_rns.ELEMS:
            assert lib.phe_rns_ladder_smem(k, E) == cuda_rns._smem(k, E)


def test_cluster_launch_counts_once_and_each_replay(dev):
    """A 16,384-row ladder at k = 304 runs E = 32 in clusters of two, on
    blocks rounded up to whole clusters, bit-equal to the plain ladder:
    cuda_rns.launches moves once for it, and once for each call of the
    encrypt program (warm-up, capture, replays), as its one ladder launch
    does."""
    sms = cuda_rns._sms(dev)
    assert cuda_rns._elems(304, 16384, sms) == 32 and cuda_rns.CLUSTER == 2
    sys_, x, digits = _ladder_inputs("n2", False, 16384, dev)
    before = dict(cuda_rns.launches)
    y = cuda_rns.ladder(x, digits, sys_, window=4)
    assert cuda_rns.launches == dict(before, rns_ladder=before["rns_ladder"]
                                     + 1)
    rows = [0, 1, 16383]
    assert torch.equal(y[rows], rns.ladder_plain(x[rows], digits, sys_,
                                                 window=4))
    pub, priv = benchmarks.fixed_key(2048)
    values = [0.5 * v for v in range(16384)]
    for _ in range(4):
        before = dict(cuda_rns.launches)
        batch = tbatch.EncryptedBatch.encrypt(pub, values, device=dev)
        torch.cuda.synchronize()
        assert cuda_rns.launches == dict(
            before, rns_ladder=before["rns_ladder"] + 1)
    assert batch.decrypt(priv) == values


def test_key_constants_built_once_per_card(dev):
    """A key's device constants built for "cuda" are the ones a batch on
    the card finds again by its tensors' device (cuda:N): one set a card,
    so a key's first decrypt does not rebuild them."""
    pub, priv = pt.generate_paillier_keypair(n_length=256)
    batch = tbatch.EncryptedBatch.encrypt(pub, [1.5, -2.0], device=dev)
    assert (batch * [2, 3]).decrypt(priv) == [3.0, -6.0]
    assert batch.mont.device.index is not None
    assert pub.device_context(dev) is pub.device_context(batch.mont.device)
    assert priv.device_context() is priv.device_context(batch.mont.device)
    assert len(pub._device_contexts) == 1
    assert len(priv._device_contexts) == 1


def _zero_counts():
    for c in (cuda_modexp.launches, cuda_rns.launches):
        for key in c:
            c[key] = 0


def _counts():
    return {k: v for c in (cuda_modexp.launches, cuda_rns.launches)
            for k, v in c.items() if v}


def _by_form(counts):
    """Launch counts by form: a limb kernel's launches in either REDC body
    (the integer pipe's counted under <form>_int) under the form's name."""
    out = {}
    for k, v in counts.items():
        if v:
            form = k[:-4] if k.endswith("_int") else k
            out[form] = out.get(form, 0) + v
    return out


def test_serialised_round_trip_of_a_card_batch(dev):
    """dump_encrypted_batch of a batch on the card, pinned (the host's
    raw_encrypt after decrease_exponent_to, JSON for JSON) and secure (re-
    obfuscated on the card), json round trip, load onto the card."""
    import json

    from phe_tpu_torch import serial

    pub, priv = pt.generate_paillier_keypair(n_length=256)
    values = [1.5, -2.0, 300.0, 0.0625, 7, -1e-3, 12345.678, 1e-40]
    rng = random.Random(11)
    rs = [rng.randrange(1, pub.n) for _ in values]
    pinned = pt.EncryptedBatch.encrypt(pub, values, r_values=rs, device=dev)
    _zero_counts()
    dumped = serial.dump_encrypted_batch(pinned, be_secure=False)
    assert _counts().get("rns_ladder_vec") == 1  # the pin to -32
    host = []
    for value, r in zip(values, rs):
        enc = pub.encrypt(value, r_value=r)
        if enc.exponent > -32:
            enc = enc.decrease_exponent_to(-32)
        host.append({"v": str(enc.ciphertext(be_secure=False)),
                     "e": enc.exponent})
    assert json.dumps(dumped) == json.dumps({"values": host})
    secure = serial.dump_encrypted_batch(
        pt.EncryptedBatch.encrypt(pub, values, r_values=rs, device=dev))
    assert all(a["v"] != b["v"] for a, b in zip(secure["values"], host))
    for data in (dumped, secure):
        back = serial.load_encrypted_batch(json.loads(json.dumps(data)), pub)
        assert back.mont.is_cuda
        assert back.decrypt(priv) == values


def test_crt_powers_on_the_card_equal_python_pow(dev):
    """The fixed 2048-bit key: mont_pow_shared at L = 152, one launch a
    prime square, canonical limbs equal to Python's pow."""
    pub, priv = benchmarks.fixed_key(2048)
    rng = random.Random(12)
    cts = [rng.randrange(1, pub.nsquare) for _ in range(37)]
    pdc = priv.device_context(dev)
    mont = pdc.pub_ctx.pack_mod_nsquare(cts)
    _zero_counts()
    xp, xq = pdc.crt_powers(mont)
    torch.cuda.synchronize()
    assert _by_form(_counts()).get("mont_pow_shared") == 2
    assert xp.is_cuda and xp.shape == (mont.shape[0], 152)
    for got, d in ((xp, priv.p), (xq, priv.q)):
        ints = hl.limbs_to_ints(got.cpu().numpy())
        assert ints[: len(cts)] == [pow(c, d - 1, d * d) for c in cts]


def test_cli_vector_pipeline_on_the_card(dev, tmp_path):
    """The six vector commands with the default --device (the card),
    through click's CliRunner, each result the exactly rounded one."""
    import json
    from fractions import Fraction

    from click.testing import CliRunner

    from phe_tpu_torch.cli import cli

    runner = CliRunner()

    def run(*args):
        result = runner.invoke(cli, [str(a) for a in args])
        assert result.exit_code == 0, result.output
        return result.stdout.strip().splitlines()[-1]

    priv, pub = tmp_path / "priv.json", tmp_path / "pub.json"
    run("genpkey", "--keysize", "256", priv)
    run("extract", priv, pub)
    vals = [1.5, -2.0, 300.0, 0.0625, -1e-3]
    plain = [10.0, 0.5, -1.0, 3.0, 1e6]
    (tmp_path / "v.json").write_text(json.dumps(vals))
    (tmp_path / "p.json").write_text(json.dumps(plain))
    _zero_counts()
    run("encryptvec", "--output", tmp_path / "e.json", pub, tmp_path / "v.json")
    assert _counts().get("rns_ladder", 0) >= 1
    assert json.loads(run("decryptvec", priv, tmp_path / "e.json")) == vals
    run("addvec", "--output", tmp_path / "a.json", pub, tmp_path / "e.json",
        tmp_path / "p.json")
    run("addencvec", "--output", tmp_path / "d.json", pub,
        tmp_path / "a.json", tmp_path / "e.json")
    run("multiplyvec", "--output", tmp_path / "m.json", pub,
        tmp_path / "d.json", tmp_path / "p.json")
    want = [float((2 * Fraction(v) + Fraction(p)) * Fraction(p))
            for v, p in zip(vals, plain)]
    assert json.loads(run("decryptvec", priv, tmp_path / "m.json")) == want
    run("sumvec", "--output", tmp_path / "s.json", pub, tmp_path / "e.json")
    assert float(run("decrypt", priv, tmp_path / "s.json")) == float(
        sum(map(Fraction, vals)))


def test_world_of_one_on_nccl(dev):
    """One process, one card, NCCL: encrypted_sum_sharded equals
    batch.sum() ciphertext for ciphertext."""
    import socket

    import torch.distributed as dist

    from phe_tpu_torch import parallel

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert parallel.initialize_distributed(
        "tcp://localhost:%d" % port, 1, 0).type == "cuda"
    try:
        assert dist.get_backend() == "nccl"
        pub, priv = pt.generate_paillier_keypair(n_length=256)
        values = [1, 2.5, -0.125, 300, 4.75, -7, 1e-3]
        batch = pt.EncryptedBatch.encrypt(pub, values, device=dev)
        mesh = parallel.batch_mesh()
        assert (mesh.dp, mesh.mp) == (1, 1) and mesh.dp_group is not None
        total = parallel.encrypted_sum_sharded(batch, mesh)
        assert total.mont.is_cuda
        assert total.ciphertext_ints(False) == batch.sum().ciphertext_ints(
            False)
        assert total.decrypt(priv) == batch.sum().decrypt(priv)
    finally:
        dist.destroy_process_group()


# -- the batch programs: captured graphs against their eager bodies ------

PROGRAM_ROWS = 64


def _program_inputs(dev):
    """(pub, priv, {step: (program, arguments)}) at the fixed 2048-bit
    key over PROGRAM_ROWS rows: the programs of encrypt, decrypt, add and
    mul_scalars (mixed signs: the inverse-selecting pow)."""
    pub, priv = benchmarks.fixed_key(2048)
    dc, pdc = pub.device_context(dev), priv.device_context(dev)
    g = np.random.default_rng(9)
    values = [float(v) for v in g.uniform(-1e6, 1e6, PROGRAM_ROWS)]
    encs = pt.EncodedNumber.encode_many(pub, values)
    m = dc.pack_messages([e.encoding for e in encs])
    r = dc.random_r_bytes(PROGRAM_ROWS)
    st = dc.rns_state()
    a = tbatch.EncryptedBatch.encrypt(pub, values, device=dev)
    b = tbatch.EncryptedBatch.encrypt(pub, values[::-1], device=dev)
    ks = [int(v) for v in g.integers(1, 1 << 50, PROGRAM_ROWS)]
    digits = tbatch._digits_on(tbatch._digits_rows(ks, 50), dev)
    neg = torch.as_tensor(g.integers(0, 2, PROGRAM_ROWS) != 0, device=dev)
    return pub, priv, {
        "encrypt": (tbatch._encrypt_rns_dev,
                    (m, r, dc.nr2_limbs, dc.n_digits, dc.ctx, st, dc.Ln)),
        "decrypt": (tbatch._decrypt_compact_rns_dev,
                    (a.mont, dc.ctx, pdc.consts) + tuple(pdc.rns_state())),
        "add": (tbatch._mul_mont_dev, (a.mont, b.mont, dc.ctx)),
        "mul_scalars": (tbatch._pow_select_dev,
                        (a.mont, a.inverse_mont(), neg, digits, dc.ctx, st)),
    }


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("step", ["encrypt", "decrypt", "add",
                                  "mul_scalars"])
def test_program_replay_equals_eager_and_counts_alike(dev, step):
    """Bit-equal to the eager body at every call (the first warms up, the
    second captures, each after it replays), each call counting the eager
    launches."""
    _, _, cases = _program_inputs(dev)
    prog, args = cases[step]
    _zero_counts()
    eager = _outs(prog.fn(*args))
    torch.cuda.synchronize()
    want_counts = _counts()
    assert want_counts
    for _ in range(3):
        _zero_counts()
        got = _outs(prog(*args))
        torch.cuda.synchronize()
        assert _counts() == want_counts
        assert len(got) == len(eager)
        assert all(torch.equal(x, y) for x, y in zip(got, eager))
    assert prog.captured >= 1


def test_program_outputs_are_not_overwritten(dev):
    """A second encrypt through the same graph leaves the first batch's
    limbs as they were."""
    pub, priv = benchmarks.fixed_key(2048)
    xs = [float(v) for v in range(PROGRAM_ROWS)]
    ys = [-2.5 * v for v in xs]
    for _ in range(2):  # the second round runs on replays only
        first = tbatch.EncryptedBatch.encrypt(pub, xs, device=dev)
        snap = first.mont.clone()
        second = tbatch.EncryptedBatch.encrypt(pub, ys, device=dev)
        torch.cuda.synchronize()
        assert torch.equal(first.mont, snap)
        assert first.mont.data_ptr() != second.mont.data_ptr()
        assert first.decrypt(priv) == xs and second.decrypt(priv) == ys


def test_round_trip_programs_wait_on_nothing(dev):
    """Upload, encrypt and decrypt's device half under
    set_sync_debug_mode("error"): no host wait (two round trips at this
    shape warm up and capture the graphs)."""
    pub, priv = benchmarks.fixed_key(2048)
    xs = [1.5 * v for v in range(PROGRAM_ROWS)]
    for _ in range(2):
        assert tbatch.EncryptedBatch.encrypt(pub, xs, device=dev).decrypt(
            priv) == xs
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        finish = tbatch.EncryptedBatch.encrypt(
            pub, xs, device=dev).decrypt_async(priv)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert finish() == xs
