"""The host side of the RNS ladder kernel's tensor-core layout, on the CPU.

csrc/rns_ladder.cu runs both base extensions as mma.sync m16n8k32 int8
products over the block's elements, reading the extension matrices in the
order ops/cuda_rns.py's pack_blocks writes them, through a ring of stages
in shared memory that each block's producer fills with bulk copies. The
kernel cannot run here, so these tests hold what surrounds it: the packed
matrices unpack to w_ext1 / w_ext2 with zero padding, stage by stage as
slab by slab; each stage the producer copies holds exactly its round's
slabs at its K-step; a numpy walk of the ring, stage by stage as the
producer copies them and K-step by K-step as each warp reads its slab
with each lane's A, B and C fragments as the PTX ISA lays them out,
equals rns._block_matmul; and the ring and the elements a block holds fit
the card's shared memory, as the kernel's note says for the main path's
shapes. Tolerance zero: exact integer arithmetic.
"""

import functools

import numpy as np
import pytest
import torch

import phe_tpu_torch as pt
from phe_tpu_torch import benchmarks
from phe_tpu_torch.ops import cuda_rns
from phe_tpu_torch.ops import rns

CPU = torch.device("cpu")
H100_SMS = 132  # multiprocessors of an H100 SXM


@functools.lru_cache(maxsize=None)
def _system(which):
    """The 256-bit test key's n^2 system, or the fixed 2048-bit key's
    p^2 (k = 152) or n^2 (k = 304) system; host builders only."""
    if which == "256":
        pub, _ = pt.generate_paillier_keypair(n_length=256)
        return rns.build_rns(pub.nsquare, CPU)
    pub, priv = benchmarks.fixed_key(2048)
    return rns.build_rns(priv.psquare if which == "p2" else pub.nsquare, CPU)


def _stages(k, elems):
    """An extension's stages as the kernel's producer copies them, in the
    order of the block's stage sequence: (round, chunk, byte offset into
    the packed matrix, bytes), each one run of the matrix and of the
    slot."""
    K1p, Kp = cuda_rns._geometry(k)
    slabs, KS, nw = K1p // 16, Kp // 32, cuda_rns._warps(k)
    kc, _ = cuda_rns._ring(k, elems)
    T = cuda_rns.TILE_BYTES
    out = []
    for r in range(-(-slabs // nw)):
        nr = min(nw, slabs - r * nw)
        for ch in range(-(-KS // kc)):
            ks0 = ch * kc
            kcc = min(kc, KS - ks0)
            out.append((r, ch, (r * nw * KS + ks0 * nr) * T, kcc * nr * T))
    return out


def _emulate(packed, dig, k, elems):
    """[3, K1p, E] block sums as the kernel's warps compute them from the
    ring.

    The stages are filled as _stages copies them; warp w takes slab
    r nw + w of round r, and at K-step ks = ch kc + kk the stage the
    kernel numbers r chunks + ch, reading its tiles at (kk nr + w) 1536
    bytes into the stage (nr: the round's slabs). In each tile lane
    (g, t) holds A registers a0..a3 (rows g, g + 8 at columns 4t..4t+3,
    then the same rows at 16 + 4t..), B registers b0, b1 (digits 4t..
    and 16 + 4t.. of element g of the n-tile, as ldmatrix reads them)
    and C registers c0..c3 (rows g, g + 8; elements 2t, 2t + 1).
    """
    K1p, Kp = cuda_rns._geometry(k)
    slabs, KS, nw = K1p // 16, Kp // 32, cuda_rns._warps(k)
    kc, _ = cuda_rns._ring(k, elems)
    chunks, T = -(-KS // kc), cuda_rns.TILE_BYTES
    E = dig.shape[0]
    d = np.zeros((E, Kp), np.int64)
    d[:, : 2 * k] = dig
    flat = packed.numpy().view(np.int8).reshape(-1)
    ring = [flat[off:off + n] for _, _, off, n in _stages(k, elems)]
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    four = np.arange(4)
    out = np.zeros((3, K1p, E), np.int64)
    for r in range(-(-slabs // nw)):
        nr = min(nw, slabs - r * nw)
        for w in range(nr):
            s = r * nw + w
            for ks in range(KS):
                ch, kk = divmod(ks, kc)
                stage = ring[r * chunks + ch]
                for b in range(3):
                    at = (kk * nr + w) * T + b * 512
                    words = stage[at:at + 512].reshape(32, 4, 4)
                    A = np.zeros((16, 32), np.int64)
                    for j in range(4):
                        rows = g + 8 * (j % 2)
                        cols = 4 * t + 16 * (j // 2)
                        A[rows[:, None], cols[:, None] + four] = words[:, j]
                    for n in range(E // 8):
                        Bt = np.zeros((32, 8), np.int64)
                        for h in range(2):
                            rows = 4 * t + 16 * h
                            Bt[rows[:, None] + four, g[:, None]] = d[
                                n * 8 + g[:, None],
                                ks * 32 + rows[:, None] + four]
                        C = A @ Bt
                        for i in range(4):
                            row, col = g + 8 * (i // 2), 2 * t + i % 2
                            out[b, s * 16 + row, n * 8 + col] += C[row, col]
    return out


@pytest.mark.parametrize("which", ["256", "p2", "n2"])
def test_fragment_pack_unpacks_and_emulates_block_matmul(which):
    sys_ = _system(which)
    k, K1 = sys_.k, sys_.k + 8
    K1p, Kp = cuda_rns._geometry(k)
    nw = cuda_rns._warps(k)
    assert K1p % 16 == 0 and Kp % 32 == 0 and K1p >= K1 and Kp >= 2 * k
    rng = np.random.default_rng(k)
    w1p, w2p = cuda_rns._columns(sys_)
    for w, packed in ((sys_.w_ext1, w1p), (sys_.w_ext2, w2p)):
        assert packed.dtype == torch.int32
        assert tuple(packed.shape) == (K1p // 16 * (Kp // 32), 3, 32, 4)
        blocks = cuda_rns.unpack_blocks(packed, 2 * k, nw).reshape(3, K1p, Kp)
        assert torch.equal(blocks[:, :K1, : 2 * k], w.reshape(3, K1, 2 * k))
        assert not blocks[:, K1:].any() and not blocks[:, :, 2 * k:].any()
    # The digits are the kernel's: canonical residues < 2^14, lo then hi.
    values = torch.as_tensor(rng.integers(0, 1 << 14, (32, k)))
    dig = rns._digits_i8(values)
    for w, packed in ((sys_.w_ext1, w1p), (sys_.w_ext2, w2p)):
        want = rns._block_matmul(w, dig)
        for E in cuda_rns.ELEMS:
            got = _emulate(packed, dig[:E].numpy(), k, E)
            for b in range(3):
                np.testing.assert_array_equal(got[b, :K1].T, want[b][:E].numpy())
            assert not got[:, K1:].any()


@pytest.mark.parametrize("per", [1, 2, 5, 10, 11])
def test_stage_ordered_pack_round_trips(per):
    """pack_blocks at any round length unpacks to the matrix it packed,
    padding zero, and holds the tiles of the slab-by-slab packing round
    by round, each round K-step by K-step (the last round short)."""
    g = np.random.default_rng(per)
    for rows, K in ((312, 608), (464, 912), (632, 1248), (21, 40)):
        w = torch.as_tensor(g.integers(-64, 64, (3 * rows, K)),
                            dtype=torch.int8)
        packed = cuda_rns.pack_blocks(w, 3, per)
        S, KS = -(-rows // 16), -(-K // 32)
        assert tuple(packed.shape) == (S * KS, 3, 32, 4)
        back = cuda_rns.unpack_blocks(packed, K, per).reshape(3, 16 * S,
                                                              32 * KS)
        assert torch.equal(back[:, :rows, :K], w.reshape(3, rows, K))
        assert not back[:, rows:].any() and not back[:, :, K:].any()
        slabwise = cuda_rns.pack_blocks(w, 3).reshape(S, KS, 3, 32, 4)
        at = 0
        for r0 in range(0, S, per):
            nr = min(per, S - r0)
            for ks in range(KS):
                assert torch.equal(packed[at:at + nr],
                                   slabwise[r0:r0 + nr, ks])
                at += nr
        assert at == S * KS


@pytest.mark.parametrize("k", [152, 304, 456, 624])
@pytest.mark.parametrize("elems", [8, 32])
def test_each_stage_holds_its_rounds_slabs_at_its_k_steps(k, elems):
    """Every stage the producer copies is one run of the packed matrix
    holding exactly the tiles of its round's slabs at its K-steps, where
    the warps read them, and splits in 16-byte halves between the two
    blocks of a cluster; an extension's stages cover every (slab, K-step)
    once. At k = 624, E = 32, two one-K-step stages fill the block's
    shared memory to the byte."""
    K1p, Kp = cuda_rns._geometry(k)
    slabs, KS, nw = K1p // 16, Kp // 32, cuda_rns._warps(k)
    kc, depth = cuda_rns._ring(k, elems)
    T = cuda_rns.TILE_BYTES
    assert depth >= 2 and 2 * depth <= elems
    if (k, elems) == (624, 32):
        assert (kc, depth) == (1, 2)
        assert cuda_rns._smem(k, elems) == cuda_rns.SMEM_LIMIT
    g = np.random.default_rng(k + elems)
    w = torch.as_tensor(g.integers(-64, 64, (3 * (k + 8), 2 * k)),
                        dtype=torch.int8)
    flat = cuda_rns.pack_blocks(w, 3, nw).view(torch.int8).reshape(-1)
    slabwise = cuda_rns.pack_blocks(w, 3).reshape(slabs, KS, 3, 32, 4)
    seen = []
    for r, ch, off, n in _stages(k, elems):
        nr = min(nw, slabs - r * nw)
        assert n % 32 == 0 and n <= kc * nw * T  # two 16-byte halves
        stage = flat[off:off + n]
        for kk in range(min(kc, KS - ch * kc)):
            for i in range(nr):
                at = (kk * nr + i) * T
                got = stage[at:at + T].view(torch.int32).reshape(3, 32, 4)
                assert torch.equal(got, slabwise[r * nw + i, ch * kc + kk])
                seen.append((r * nw + i, ch * kc + kk))
    assert sorted(seen) == [(s, ks) for s in range(slabs) for ks in range(KS)]


def test_elems_fit_and_pick_the_path_shapes():
    # Every k the channel supply allows (multiples of 8, 2k + 1 primes).
    top = (len(rns._channel_supply()) - 1) // 2
    for k in range(8, top + 1, 8):
        for B in (1, 7, 9, 512, 2112, 4224, 16384, 65536):
            e = cuda_rns._elems(k, B, H100_SMS)
            assert e in cuda_rns.ELEMS
            assert cuda_rns._smem(k, e) <= cuda_rns.SMEM_LIMIT
    # The main path's shapes, as csrc/rns_ladder.cu's note gives them.
    assert cuda_rns._elems(304, 16384, H100_SMS) == 32
    assert cuda_rns._elems(304, 65536, H100_SMS) == 32
    assert cuda_rns._elems(152, 16384, H100_SMS) == 32
    assert cuda_rns._elems(624, 512, H100_SMS) == 8
    assert cuda_rns._smem(304, 32) == 222208  # 99,328 and the ring
    assert cuda_rns._smem(624, 8) == 111872  # 50,432 and the ring
    # One residue row an element and a ring of two whole-round stages:
    # 32 elements fit up to k = 624 (the 8192-bit key's p^2, to the byte);
    # past it, at the channel supply's last k, a batch takes E = 8: a
    # range lost to the ring, open in ROADMAP.md's Queue 3, item 1.
    assert cuda_rns._smem(624, 32) == 232448 == cuda_rns.SMEM_LIMIT
    assert cuda_rns._smem(632, 32) > cuda_rns.SMEM_LIMIT
    assert cuda_rns._smem(720, 32) > cuda_rns.SMEM_LIMIT
    assert cuda_rns._elems(624, H100_SMS * 32, H100_SMS) == 32
    assert cuda_rns._elems(664, H100_SMS * 32, H100_SMS) == 8
    # The 3072-bit key's n^2: E = 32 at a full call, E = 8 at a short one.
    assert cuda_rns._smem(456, 32) == 209920 <= cuda_rns.SMEM_LIMIT
    assert cuda_rns._elems(456, 16384, H100_SMS) == 32
    assert cuda_rns._elems(456, 4096, H100_SMS) == 8
    # Small batches take the narrowest block; E = 32 from the first batch
    # whose blocks cover every SM, on whatever count the card reports.
    for sms in (H100_SMS, 114):
        assert [cuda_rns._elems(40, B, sms)
                for B in (1, 21, (sms - 1) * 32, (sms - 1) * 32 + 1)] == [
            8, 8, 8, 32]
    for B in (1, 7, 8, 9, 21, 4225):
        e = cuda_rns._elems(304, B, H100_SMS)
        tab = cuda_rns._table(B, e, 5, 616, "meta")
        assert tuple(tab.shape[1:]) == (32, 616)
        # Whole clusters: an odd count of blocks gains the spare block.
        w = cuda_rns.CLUSTER
        assert tab.shape[0] == -(-B // (w * e)) * w * e
        assert B <= tab.shape[0] < B + w * e


# (k, E) -> (kc, depth, bytes): the ring at the path's k, from the rows
# (_base) and TILE_BYTES a slab and K-step of a whole-round stage.
RING = {
    (152, 8): (3, 2, 104960), (152, 32): (4, 2, 174080),
    (304, 8): (2, 2, 86272), (304, 32): (4, 2, 222208),
    (456, 8): (2, 2, 98560), (456, 32): (2, 2, 209920),
    (624, 8): (2, 2, 111872), (624, 32): (1, 2, 232448),
}


@pytest.mark.parametrize("k,elems", sorted(RING))
def test_ring_smem_at_the_path_shapes(k, elems):
    kc, depth, nbytes = RING[(k, elems)]
    stage = kc * 10 * cuda_rns.TILE_BYTES
    assert cuda_rns._warps(k) == 10
    assert cuda_rns._ring(k, elems) == (kc, depth)
    assert cuda_rns._smem(k, elems) == nbytes == (
        cuda_rns._base(k, elems) + depth * stage)
    # The most K-steps of which two stages fit, and as many of those as
    # fit (the digit rows hold two barriers a stage).
    limit = cuda_rns.SMEM_LIMIT if elems == 32 else cuda_rns.PAIR_LIMIT
    assert nbytes <= limit
    assert nbytes + stage > limit or 2 * (depth + 1) > elems
    if kc < cuda_rns.MAX_STAGE_STEPS:
        assert cuda_rns._base(k, elems) + 2 * (kc + 1) * 10 * (
            cuda_rns.TILE_BYTES) > limit


def test_ring_fits_at_every_k_of_the_channel_supply():
    """Eight elements fit at every k of the channel supply, 32 up to
    k = 624; each ring has two stages at least and its barriers fit in
    the digit rows."""
    top = (len(rns._channel_supply()) - 1) // 2
    for k in range(8, top + 1):
        assert 1 <= cuda_rns._warps(k) <= cuda_rns.MAX_WARPS
        for elems in cuda_rns.ELEMS:
            kc, depth = cuda_rns._ring(k, elems)
            if elems == 8 or k <= 624:
                assert 2 <= depth and 2 * depth <= elems
                assert 1 <= kc <= cuda_rns.MAX_STAGE_STEPS
        assert cuda_rns._smem(k, 8) <= cuda_rns.PAIR_LIMIT
        assert (cuda_rns._smem(k, 32) <= cuda_rns.SMEM_LIMIT) == (k <= 624)


def _montmul_one_row(row, beta, y, sys_):
    """The phase order of Ladder::montmul's in-place layout, written out
    in PyTorch: row [E, cpad + 4] holds each element's residues and beta
    [E] one word, and each phase reads and overwrites just the channels
    the kernel's does, so a phase order that read a channel after an
    earlier phase had overwritten it would show. y is [E, cpad] (the row
    itself for a squaring). This runs no kernel code, and each phase is
    one vectorised step, so it cannot show a race between the threads of
    one phase: the GPU tests' bit-equality checks hold the kernel."""
    k, C, K1 = sys_.k, sys_.cpad, sys_.k + 8
    m, mu, t14 = sys_.m, sys_.mu, sys_.t14
    # 1. The channel products, in place.
    row[:, :C] = row[:, :C] * y
    # 2. sigma reads the A products into the digit row.
    v = row[:, :k]
    sigma = rns._mod((v >> 14) * sys_.sig2[:k] + (v & 0x3FFF) * sys_.sig1[:k],
                     m[:k], mu[:k])
    dig = rns._digits_i8(sigma)
    # 3. Extension 1: each (channel k + j, element) reads its product, then
    # writes u~ over it.
    ch = slice(k, k + K1)
    c0, c1, c2 = rns._block_matmul(sys_.w_ext1, dig)
    qh = rns._combine_mod(c0, c1, c2, m[ch], mu[ch], t14[ch])
    r = row[:, ch].clone()
    row[:, ch] = rns._mod((r >> 14) * sys_.d2[ch] + (r & 0x3FFF) * sys_.d1[ch]
                          + qh * sys_.e1[ch], m[ch], mu[ch])
    # 4. The tau digits from B's u~.
    dig = rns._digits_i8(row[:, k:2 * k])
    # 5. Extension 2: S row j < k over the A products, row k to beta; the
    # rows past k go nowhere (the row holds u~ there).
    c0, c1, c2 = rns._block_matmul(sys_.w_ext2, dig)
    S_k = slice(k, k + 1)
    row[:, :k] = rns._combine_raw(c0[:, :k], c1[:, :k], c2[:, :k], m[:k],
                                  mu[:k], t14[:k])
    beta[:] = rns._combine_raw(c0[:, S_k], c1[:, S_k], c2[:, S_k],
                               m[2 * k:2 * k + 1], mu[2 * k:2 * k + 1],
                               t14[2 * k:2 * k + 1])[:, 0]
    # 6. beta from S row k and u~ on the redundant channel 2k.
    sr = rns._mod(beta, sys_.m_r, sys_.mu_r)
    beta[:] = rns._mod((sr + (sys_.m_r - row[:, 2 * k])) * sys_.mbinv_r,
                       sys_.m_r, sys_.mu_r)
    # 7. The last reduction writes the A channels back in place.
    row[:, :k] = rns._mod(row[:, :k] + beta[:, None] * sys_.neg_mb[:k],
                          m[:k], mu[:k])


@pytest.mark.parametrize("which", ["256", "p2", "n2"])
@pytest.mark.parametrize("square", [False, True], ids=["product", "square"])
def test_one_row_in_place_product_equals_rns_mont_mul(which, square):
    """Eight chained products on one residue row an element, with the
    skew columns and beta poisoned, bit-equal to rns.rns_mont_mul: the
    in-place layout's data flow is sound. It documents the kernel's
    design and does not test the kernel (see _montmul_one_row)."""
    sys_ = _system(which)
    C, E = sys_.cpad, 8
    g = np.random.default_rng(sys_.k + square)
    x = torch.as_tensor(g.integers(0, 1 << 14, (E, C))) % sys_.m
    y = torch.as_tensor(g.integers(0, 1 << 14, (E, C))) % sys_.m
    row = torch.full((E, C + 4), -(1 << 40), dtype=torch.int64)
    row[:, :C] = x
    beta = torch.full((E,), -(1 << 40), dtype=torch.int64)
    want = x
    for _ in range(8):
        _montmul_one_row(row, beta, row[:, :C].clone() if square else y, sys_)
        want = rns.rns_mont_mul(want, want if square else y, sys_)
        assert torch.equal(row[:, :C], want)
    assert (row[:, C:] == -(1 << 40)).all()
