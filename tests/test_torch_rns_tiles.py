"""The host side of the RNS ladder kernel's tensor-core layout, on the CPU.

csrc/rns_ladder.cu runs both base extensions as mma.sync m16n8k32 int8
products over the block's elements, reading the extension matrices in the
order ops/cuda_rns.py's pack_blocks writes them. The kernel cannot run
here, so these tests hold what surrounds it: the packed matrices unpack to
w_ext1 / w_ext2 with zero padding; a numpy walk of the packed tiles, slab
by slab and K-step by K-step with each lane's A, B and C fragments as the
PTX ISA lays them out, equals rns._block_matmul; and the elements a block
holds fit the card's shared memory, as the kernel's note says for the
main path's shapes. Tolerance zero: exact integer arithmetic.
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


def _emulate(packed, dig, k):
    """[3, K1p, E] block sums as the kernel's warps compute them.

    For each slab and K-step, lane (g, t) holds A registers a0..a3 (rows
    g, g + 8 at columns 4t..4t+3, then the same rows at 16 + 4t..), B
    registers b0, b1 (digits 4t.. and 16 + 4t.. of element g of the
    n-tile) and C registers c0..c3 (rows g, g + 8; elements 2t, 2t + 1).
    """
    K1p, Kp = cuda_rns._geometry(k)
    S, KS = K1p // 16, Kp // 32
    E = dig.shape[0]
    d = np.zeros((E, Kp), np.int64)
    d[:, : 2 * k] = dig
    words = packed.numpy().view(np.int8).reshape(S, KS, 3, 32, 4, 4)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    four = np.arange(4)
    out = np.zeros((3, K1p, E), np.int64)
    for s in range(S):
        for ks in range(KS):
            for b in range(3):
                A = np.zeros((16, 32), np.int64)
                for j in range(4):
                    rows = g + 8 * (j % 2)
                    cols = 4 * t + 16 * (j // 2)
                    A[rows[:, None], cols[:, None] + four] = words[s, ks, b, :, j]
                for n in range(E // 8):
                    Bt = np.zeros((32, 8), np.int64)
                    for r in range(2):
                        rows = 4 * t + 16 * r
                        Bt[rows[:, None] + four, g[:, None]] = d[
                            n * 8 + g[:, None], ks * 32 + rows[:, None] + four]
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
    assert K1p % 16 == 0 and Kp % 32 == 0 and K1p >= K1 and Kp >= 2 * k
    rng = np.random.default_rng(k)
    for w in (sys_.w_ext1, sys_.w_ext2):
        packed = cuda_rns.pack_blocks(w, 3)
        assert packed.dtype == torch.int32
        assert tuple(packed.shape) == (K1p // 16, Kp // 32, 3, 32, 4)
        blocks = cuda_rns.unpack_blocks(packed).reshape(3, K1p, Kp)
        assert torch.equal(blocks[:, :K1, : 2 * k], w.reshape(3, K1, 2 * k))
        assert not blocks[:, K1:].any() and not blocks[:, :, 2 * k:].any()
    # The digits are the kernel's: canonical residues < 2^14, lo then hi.
    E = 32 if which == "256" else 8
    values = torch.as_tensor(rng.integers(0, 1 << 14, (E, k)))
    dig = rns._digits_i8(values)
    for w in (sys_.w_ext1, sys_.w_ext2):
        got = _emulate(cuda_rns.pack_blocks(w, 3), dig.numpy(), k)
        want = rns._block_matmul(w, dig)
        for b in range(3):
            np.testing.assert_array_equal(got[b, :K1].T, want[b].numpy())
        assert not got[:, K1:].any()


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
    assert cuda_rns._smem(304, 32) == 99456
    assert cuda_rns._smem(624, 8) == 50464
    # One residue row an element: 32 elements fit at every k of the
    # channel supply (k <= 664), and first overflow at k = 720.
    assert cuda_rns._smem(624, 32) == 201856
    assert cuda_rns._smem(664, 32) <= cuda_rns.SMEM_LIMIT
    assert cuda_rns._smem(720, 32) > cuda_rns.SMEM_LIMIT
    assert cuda_rns._elems(624, H100_SMS * 32, H100_SMS) == 32
    # The 3072-bit key's n^2: E = 32 at a full call, E = 8 at a short one.
    assert cuda_rns._smem(456, 32) == 148608 <= cuda_rns.SMEM_LIMIT
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
        assert tab.shape[0] % e == 0 and B <= tab.shape[0] < B + e
        assert tuple(tab.shape[1:]) == (32, 616)


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
