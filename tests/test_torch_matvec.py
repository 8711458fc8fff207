"""The shared-table matvec against per-element modexps, on the CPU.

batch._matvec (each base's 16-row table built once, the constant-time
select of cuda_modexp.table_select, a product tree a chunk of bases,
Horner a row) is held to the parent's algorithm, one modexp a grid
element (batch._pow_elems) then a product tree, ciphertext for ciphertext
mod n^2 at a 255-bit key, on both routes of the per-element modexp (the
RNS ladder and the limb engine's modexp): rows far below and far above
the bases, mixed signs and no negative entry (no inverse table), zero
entries and zero windows, the alignment diffs of matvec's grid, an odd
count of bases (the tree's carry), one window and 24, and bases split
into chunks. The select's plain version is held to a direct indexing of
the tables; matvec passes the inverses only where an entry is negative,
and a one-element grid decrypts to its product. Tolerance zero: exact
integer arithmetic.
"""

import numpy as np
import pytest
import torch

from paillier_bench.reference import paillier as ref
from phe_tpu_torch import batch as tbatch
from phe_tpu_torch.batch import EncryptedBatch
from phe_tpu_torch.keys import PaillierPrivateKey, PaillierPublicKey
from phe_tpu_torch.ops import cuda_modexp
from phe_tpu_torch.utils import limbs as hl

# Two fixed 128-bit primes: a 255-bit n, small enough for the CPU.
P = 0x80000000000000000000000001234581
Q = 0xC00000000000000000000000089ABCD1


@pytest.fixture(scope="module")
def keys():
    pub = PaillierPublicKey(P * Q)
    return pub, PaillierPrivateKey(pub, P, Q)


@pytest.fixture(scope="module")
def vector(keys):
    """40 ciphertexts at exponents that differ, and their inverses."""
    rng = np.random.default_rng(26)
    v = rng.normal(0.0, 0.3, 40) * 16.0 ** rng.integers(-3, 3, 40)
    batch = EncryptedBatch.encrypt(keys[0], v.tolist(), device="cpu")
    return batch, batch.inverse_mont()


def _ints(mont, pub):
    return [v % pub.nsquare for v in hl.limbs_to_ints(mont.numpy())]


def _per_element(mont, inv_mont, neg_mask, digits, ctx, rstate):
    """The grid as B D per-element modexps, then a tree over D."""
    grid = (digits.shape[0],) + tuple(mont.shape)
    base = torch.where(neg_mask[..., None], inv_mont.expand(grid),
                       mont.expand(grid))
    powed = tbatch._pow_elems(base, digits, ctx, rstate)  # [B, D, L]
    return tbatch._tree_fold(powed.transpose(0, 1), ctx)[0]


# name: (rows B, bases D, windows W, entries)
CASES = {
    "rows_below_bases_odd": (2, 33, 8, "mixed"),
    "rows_above_bases": (24, 3, 8, "mixed"),
    "non_negative": (3, 9, 8, "non_negative"),
    "zero_entries_and_windows": (3, 10, 16, "zeros"),
    "aligned_grid": (3, 40, None, "aligned"),
    "one_window": (4, 5, 1, "mixed"),
    "wide": (2, 7, 24, "mixed"),
    "chunked": (3, 11, 8, "chunks"),
}


@pytest.mark.parametrize("route", ["rns", "limb"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_shared_table_equals_per_element(keys, vector, monkeypatch, case,
                                         route):
    pub, _ = keys
    batch, inv_all = vector
    B, D, W, kind = CASES[case]
    rng = np.random.default_rng(len(case) * 7 + B)
    if kind == "aligned":
        digits, neg, _ = batch._grid(rng.normal(0.0, 1.0, (B, D)))
        # The vector's exponents differ, so entries align to their row's
        # least: their digits move up by the diff.
        assert len(set(batch.exponents[:D].tolist())) > 1
        assert neg.any() and not neg.all()
    else:
        digits = rng.integers(0, 16, (B, D, W)).astype(np.int8)
        neg = rng.random((B, D)) < 0.5
        if kind == "non_negative":
            neg[:] = False
        if kind == "zeros":
            digits[:, ::3] = 0  # zero entries
            digits[..., 1::4] = 0  # zero windows in every entry
    if kind == "chunks":
        # Room for five bases a chunk, so four: 11 bases in chunks of 4, 4
        # and 3 (an odd level's carry in the last).
        monkeypatch.setattr(tbatch, "_SELECT_BYTES",
                            5 * 8 * B * W * batch._dc.L)
        assert tbatch._select_bases(B, D, W, batch._dc.L) == 4
    dc = batch._dc
    mont, inv = batch.mont[:D], inv_all[:D]
    mask = torch.as_tensor(neg)
    dg = tbatch._digits_on(digits, dc.device)
    shared = tbatch._matvec(mont, inv if neg.any() else None, mask, dg,
                            dc.ctx)
    per = _per_element(mont, inv, mask, dg, dc.ctx,
                       dc.rns_state() if route == "rns" else None)
    assert shared.shape == per.shape == (B, dc.L)
    assert _ints(shared, pub) == _ints(per, pub)


@pytest.mark.parametrize("signs,i0,dc", [(1, 0, 7), (2, 0, 7), (2, 2, 4)])
def test_select_plain_indexes_the_tables(signs, i0, dc):
    rng = np.random.default_rng(10 * signs + i0)
    D, B, W, L = 7, 3, 5, 8
    table = torch.as_tensor(rng.integers(0, 1 << 14, (16, signs, D, L)))
    digits = torch.as_tensor(rng.integers(0, 16, (B, D, W)), dtype=torch.int8)
    neg = torch.as_tensor(rng.random((B, D)) < 0.5)
    got = cuda_modexp.table_select(table, digits, neg, i0, dc)
    assert got.shape == (dc, B, W, L) and got.dtype == torch.int64
    for i in range(i0, i0 + dc):
        for j in range(B):
            s = int(neg[j, i]) if signs == 2 else 0
            for w in range(W):
                assert torch.equal(got[i - i0, j, w],
                                   table[int(digits[j, i, w]), s, i])


def test_matvec_passes_the_inverses_only_for_negative_entries(keys,
                                                              monkeypatch):
    """vfl_credit-2048's two grids (13 and 11 features against 30,000
    residuals) carry the batch's inverses, a non-negative grid none (the
    one-sign table). The program is stubbed: the grids' host build runs,
    their arithmetic does not."""
    pub, _ = keys
    rng = np.random.default_rng(27)
    rows = 30000
    L = pub.device_context(torch.device("cpu")).L
    d = EncryptedBatch(pub, torch.zeros((32768, L), dtype=torch.int64),
                       ref.encode_array(rng.normal(0.0, 0.3, rows))[1])
    d._inv_mont = d.mont
    calls = []

    def stub(mont, inv_mont, neg_mask, digits, ctx):
        calls.append((digits.shape, inv_mont is not None,
                      bool(neg_mask.any())))
        return torch.zeros((digits.shape[0], ctx.num_limbs),
                           dtype=torch.int64)

    monkeypatch.setattr(tbatch, "_matvec_dev", stub)
    X = rng.normal(0.0, 1.0, (24, rows))
    for features in (X[:13], X[13:], np.abs(X[:13])):
        d.matvec(features)
    assert [c[0][:2] for c in calls] == [(13, rows), (11, rows), (13, rows)]
    assert all(c[0][2] >= 16 for c in calls)
    assert [c[1:] for c in calls] == [(True, True), (True, True),
                                      (False, False)]


@pytest.mark.parametrize("entry", [-3.0, 3.0])
def test_one_element_grid(keys, entry):
    pub, priv = keys
    got = EncryptedBatch.encrypt(pub, [2.5], device="cpu").matvec([[entry]])
    assert got.decrypt(priv) == [2.5 * entry]
