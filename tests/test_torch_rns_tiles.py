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
    assert cuda_rns._smem(304, 32) == 178816
    assert cuda_rns._smem(624, 8) == 90784
    assert cuda_rns._smem(624, 32) > cuda_rns.SMEM_LIMIT
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
