"""The host side of the REDC tile's design, on the CPU.

csrc/redc_tile.cuh runs Montgomery products for E row slots a block, for
the limb-engine modexp (csrc/mont_pow.cu) and the Montgomery product
(csrc/mont_mul.cu): a * b on the CUDA cores in runs of adjacent columns
held in registers, both constant products of each reduction as mma.sync
m16n8k32 int8 products over the row slots (phe_tpu's REDC matrices,
packed by cuda_rns.pack_blocks), and two-pass run carries. The kernels
cannot run here, so these tests hold what surrounds them: the port's REDC
matrices are array-equal to phe_tpu's _build_redc_matrices (and, past
phe_tpu's L = 507 ceiling, exact against Python ints); the packed matrices
unpack to them; a numpy walk of one product as the tile runs it (its run
jobs, carry passes, digit rows, MMA fragments read lane by lane as the PTX
ISA lays them out, and 64-bit epilogues) equals the plain Montgomery
product in value mod M and keeps its bounds, on rows with limbs of
exactly 2^14, and so does the walk of the integer-pipe body (T_lo M' and
q M as two more run passes against shared M' and M rows); the same walks over the product kernel's blocks
(live rows of E slots, a ragged last block, b broadcast in the shared
form, L = 8) equal phe_tpu's mont_mul and mont_mul_const kernels in
interpret mode with the same REDC body; and the rows a block holds fit
the card's shared memory. Tolerance zero:
exact integer arithmetic.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import phe_tpu
from phe_tpu.ops import montgomery as jmg
from phe_tpu.ops import pallas_modexp as jpmx

from phe_tpu_torch import benchmarks
from phe_tpu_torch import interop
from phe_tpu_torch.ops import cuda_modexp as cm
from phe_tpu_torch.ops import cuda_rns
from phe_tpu_torch.ops import montgomery as mg
from phe_tpu_torch.utils import limbs as hl

CPU = torch.device("cpu")
H100_SMS = 132  # multiprocessors of an H100 SXM
# The one-row tile's clusters of C blocks an H100 SXM holds at once
# (cudaOccupancyMaxActiveClusters at L = 1,176; compare_redc_int.py).
H100_FIT = {1: 132, 2: 66, 4: 30, 8: 15}
MASK = (1 << 14) - 1


@functools.lru_cache(maxsize=None)
def _modulus(which):
    """n^2 of a 256-bit test key, of the fixed 2048-bit key (L = 296), or
    of the fixed 8192-bit key (L = 1,176); or p of a 128-bit key ("p128",
    L = 8: the half-width contexts of the smallest keys); or the fixed
    2048-bit key's p ("p2048", L = 80) and p^2 ("pp2048", L = 152)."""
    if which == "256":
        pub, _ = phe_tpu.generate_paillier_keypair(n_length=256)
        return pub.nsquare
    if which == "p128":
        _, priv = phe_tpu.generate_paillier_keypair(n_length=128)
        return priv.p
    if which in ("p2048", "pp2048"):
        p = benchmarks.fixed_key(2048)[1].p
        return p if which == "p2048" else p * p
    return benchmarks.fixed_key(int(which))[0].nsquare


def _operands(rng, M, L, rows):
    """[rows, L] limbs of values below 2.01 M: canonical values in [0, 2M),
    and every third row redundant limbs in [0, 2^14] below M's top limb,
    several exactly 2^14; the first rows zero and all-2^14."""
    top = (M.bit_length() - 1) // 14
    vals = [int.from_bytes(rng.bytes(8 * L), "little") % (2 * M)
            for _ in range(rows)]
    out = hl.ints_to_limbs(vals, L).astype(np.int64)
    for i in range(2, rows, 3):
        out[i] = 0
        out[i, :top] = rng.integers(0, (1 << 14) + 1, top)
        out[i, rng.integers(0, top, 6)] = 1 << 14
    out[0] = 0
    out[1] = 0
    out[1, :top] = 1 << 14
    return out


@pytest.mark.parametrize("which", ["p128", "256", "2048"])
def test_redc_matrices_array_equal_to_phe_tpu(which):
    M = _modulus(which)
    jctx = jmg.build_context(M)
    assert jctx.w_mq is not None
    ctx = mg.build_context(M, CPU)
    got = mg.redc_matrices(ctx)
    # Host copies: the card keeps only the kernel's packed operands.
    assert all(getattr(got, f).device == CPU for f in mg.RedcMatrices._fields)
    for f in mg.RedcMatrices._fields:
        want = np.asarray(getattr(jctx, f))
        have = getattr(got, f).numpy()
        assert have.shape == want.shape, f
        np.testing.assert_array_equal(have.astype(np.int64),
                                      want.astype(np.int64), err_msg=f)
    assert got.w_mq.dtype == got.w_m.dtype == torch.int8
    # Carried across from phe_tpu, they are the context's own.
    d = {f: np.asarray(getattr(jctx, f)) for f in jctx._fields}
    carried = interop.montgomery_context(d, CPU)
    mats = mg.redc_matrices(carried)
    assert mg.redc_matrices(carried) is mats
    for f in mg.RedcMatrices._fields:
        assert torch.equal(getattr(mats, f).long(), getattr(got, f).long()), f
    assert ctx.num_limbs == {"p128": 8, "256": 40, "2048": 296}[which]


def test_redc_matrices_past_phe_tpus_ceiling_against_python_ints():
    """L = 1,176, where phe_tpu refuses: the recombined digit products are
    T_lo M' mod R and q M, so T + q M is divisible by R."""
    M = _modulus("8192")
    L = mg.num_limbs_for_modulus(M.bit_length())
    assert L == 1176 > 507
    R = 1 << (14 * L)
    m_prime = (-pow(M, -1, R)) % R
    mats = mg.build_redc_matrices(M, L, CPU)
    wq, wmm = mats.w_mq.numpy().astype(np.int64), mats.w_m.numpy().astype(
        np.int64)
    rng = np.random.default_rng(1176)
    for T in [int.from_bytes(rng.bytes(28 * L), "little") % (R * M), R - 1]:
        lo = hl.int_to_limbs(T % R, L).astype(np.int64)
        lo[-3:] = 1 << 14  # redundant limbs: a high digit of 128
        t_lo = hl.limbs_to_int(lo)
        T = T - T % R + t_lo
        d = np.concatenate([lo & 0x7F, (lo >> 7) - 64])
        qd = wq @ d + mats.c_mq.numpy()
        assert np.abs(wq @ d).max() < 1 << 31
        q = sum(int(v) << (14 * i) for i, v in enumerate(qd[:L])) + sum(
            int(v) << (14 * i + 7) for i, v in enumerate(qd[L:]))
        assert q % R == t_lo * m_prime % R
        ql = hl.int_to_limbs(q % R, L).astype(np.int64)
        pd = wmm @ np.concatenate([ql & 0x7F, (ql >> 7) - 64]) + mats.c_m.numpy()
        qm = sum(int(v) << (14 * i) for i, v in enumerate(pd[: 2 * L])) + sum(
            int(v) << (14 * i + 7) for i, v in enumerate(pd[2 * L:]))
        assert qm == (q % R) * M
        assert (T + qm) % R == 0


def _slabwise(packed, K):
    """pack_blocks' tiles of a K-column matrix, slab by slab (its order
    with one slab a round), as [S, KS, nb, 32, 4]."""
    KS = -(-K // 32)
    return packed.reshape(-1, KS, *packed.shape[1:])


def _walk_mma(packed, dig):
    """[nb, Rp, N] block sums as the kernel's warps compute them over N
    row slots (N a multiple of 8): each lane's A registers (rows g, g + 8
    at columns 4t .. 4t + 3, then 16 + 4t ..) placed from the packed
    words; each n-tile n's B fragment read from the digit rows as the
    kernel reads it (lane (g, t) holds digits 32 ks + 4t .. 4t + 3 and
    32 ks + 16 + 4t .. of slot 8n + g, at dig + (8n + g) ds + 32 ks + 4t
    and 16 bytes on); C register i = 2h + x of lane (g, t) is row
    g + 8h of the slab, slot 8n + 2t + x, as the epilogues store it."""
    S, KS, nb = packed.shape[:3]
    words = packed.numpy().view(np.int8).reshape(S, KS, nb, 32, 4, 4)
    s = np.arange(S)[:, None, None, None, None, None]
    ks = np.arange(KS)[None, :, None, None, None, None]
    b = np.arange(nb)[None, None, :, None, None, None]
    lane = np.arange(32)[None, None, None, :, None, None]
    j = np.arange(4)[None, None, None, None, :, None]
    q = np.arange(4)[None, None, None, None, None, :]
    g, t = lane >> 2, lane & 3
    A = np.zeros((nb, 16 * S, 32 * KS), np.int64)
    A[b, 16 * s + g + 8 * (j % 2), 32 * ks + 4 * t + 16 * (j // 2) + q] = words
    N = len(dig)
    assert N % 8 == 0
    # B: lane (gb, tb), register r // 4, byte r % 4 of every K-step.
    kb = np.arange(KS)[:, None, None]
    lb = np.arange(32)[None, :, None]
    r = np.arange(8)[None, None, :]
    gb, tb = lb >> 2, lb & 3
    k = 32 * kb + 4 * tb + 16 * (r // 4) + r % 4
    # C: lane (gc, tc), register i = 2h + x.
    lc = np.arange(32)[:, None]
    h, x = np.arange(4)[None, :] // 2, np.arange(4)[None, :] % 2
    gc, tc = lc >> 2, lc & 3
    C = np.zeros((nb, 16 * S, N), np.int64)
    for n in range(N // 8):
        Bt = np.zeros((32 * KS, 8), np.int64)
        Bt[k, gb] = dig[8 * n + gb, k]
        D = A @ Bt  # [nb, 16 S, 8]: the n-tile's MMA sums, slab by slab
        for sl in range(S):
            C[:, 16 * sl + gc + 8 * h, 8 * n + 2 * tc + x] = D[
                :, 16 * sl + gc + 8 * h, 2 * tc + x]
    assert np.abs(C).max() < 1 << 31  # the MMA's int32 accumulators
    np.testing.assert_array_equal(C, A @ dig[:, : 32 * KS].T.astype(np.int64))
    return C


def _ripple(x, c1, c2, runs, flag=None, L=None):
    """The kernel's second carry pass over `runs` runs of x (in place)."""
    r = cm.POW_RUN
    for k in range(runs):
        carry = c1[:, k - 1].copy() if k else np.zeros(len(x), np.int64)
        anyv = np.zeros(len(x), np.int64)
        for j in range(r):
            v = x[:, k * r + j] + carry
            x[:, k * r + j] = v & MASK
            carry = v >> 14
            anyv |= x[:, k * r + j]
        assert carry.max() <= 1
        c2[:, k] = carry
        if flag is not None and k < L // r:
            flag |= (anyv != 0) | ((k + 1 < L // r) & (carry != 0))


def _limb(x, c2, c):
    r = cm.POW_RUN
    k = c // r
    return x[:, c] + (c2[:, k - 1] if c == k * r and k else 0)


def _split(lo, hi, c1, runs):
    """The kernel's first carry pass over columns lo[c] + hi[c - 1]."""
    r = cm.POW_RUN
    for k in range(runs):
        carry = np.zeros(len(lo), np.int64)
        for j in range(r):
            c = k * r + j
            v = lo[:, c] + (hi[:, c - 1] if c else 0) + carry
            assert v.max() < 1 << 32
            lo[:, c] = v & MASK
            carry = v >> 14
        c1[:, k] = carry


def _digits(x, L, ds, slots):
    """The digit rows of `slots` row slots: x's rows first, the rest zero
    (the block is zeroed and only live rows' digits are written)."""
    dig = np.zeros((slots, ds), np.int64)
    dig[: len(x), :L] = x & 0x7F
    dig[: len(x), L: 2 * L] = (x >> 7) - 64
    assert x.max() <= 1 << 14 and x.min() >= 0
    return dig


def _run_columns(A, Bf, L, c0, square):
    """[E, kRun] column sums c0 ... c0 + kRun - 1 of A * Bf (operand rows
    padded by POW_PAD zero limbs either side) as a run job computes them:
    blocks of kRun limbs of A against a sliding window of Bf, a squaring's
    cross terms once, doubled, plus the diagonal."""
    r, P = cm.POW_RUN, cm.POW_PAD
    E = len(A)
    tz = np.arange(r)[None, :] - np.arange(r)[:, None] + r - 1  # [ii, j]
    ii, jj = np.meshgrid(np.arange(r), np.arange(r), indexing="ij")
    s = np.zeros((E, r), np.int64)
    i0 = (c0 - (L - 1)) & ~(r - 1) if c0 - (L - 1) > 0 else 0
    i_hi = min(c0 + r - 1, L - 1)
    if square:
        i_hi = min(i_hi, (c0 + r - 2) // 2)
    i_full = (c0 - 2 * r + 2) // 2 if square else i_hi + 1
    while i0 <= i_hi:
        lo_b = P + c0 - i0 - r + 1
        assert lo_b >= 0 and lo_b + 2 * r - 1 <= Bf.shape[1]
        assert P + i0 + r <= A.shape[1]
        av = A[:, P + i0: P + i0 + r]
        bb = Bf[:, lo_b: lo_b + 2 * r - 1]
        prod = av[:, :, None] * bb[:, tz]
        if square and not i0 < i_full:
            prod = prod * (2 * (i0 + ii) < c0 + jj)
        p = prod.sum(axis=1)
        assert p.max() < 1 << 32  # unsigned partial sums
        s += p
        i0 += r
    if square:
        for j in range(r):
            c = c0 + j
            d = 0 if c & 1 else A[:, P + (c >> 1)]
            s[:, j] = 2 * s[:, j] + d * d
    return s


def _put_run(out, s, c1, k):
    """A run's columns s normalised into out (in place); c1 <- its
    carry-out."""
    r = cm.POW_RUN
    carry = np.zeros(len(out), np.int64)
    for j in range(r):
        v = s[:, j] + carry
        out[:, k * r + j] = v & MASK
        carry = v >> 14
    assert carry.max() < 1 << 26
    c1[:, k] = carry


THREADS = 384  # csrc/redc_tile.cuh's kThreads


def _run_at(p, runs, tent):
    """The tile's run_at: position p of `runs` runs in falling order of
    cost (a tent's two middle runs first, then outwards in pairs; a
    rising triangle's top run first)."""
    if not tent:
        return runs - 1 - p
    v, h = p >> 1, runs >> 1
    return h + v if p & 1 else h - 1 - v


def _balanced(runs, tent, live):
    """The tile's balanced(): [(thread, run, row)] in the order its
    threads take them, threads in snake order round by round."""
    out, n = [], runs * live
    for r in range(-(-n // THREADS)):
        for t in range(THREADS):
            idx = r * THREADS + (THREADS - 1 - t if r & 1 else t)
            if idx < n:
                p = idx // live
                out.append((t, _run_at(p, runs, tent), idx - p * live))
    assert sorted((k, e) for _, k, e in out) == [
        (k, e) for k in range(runs) for e in range(live)]
    return out


def _emulate_product(a, b, ctx, square, slots=None, cluster=None,
                     body=True):
    """One Montgomery product of the tile's live rows a (and b) as
    csrc/redc_tile.cuh runs it for ctx: the int8 body (body True) against
    its packed REDC matrices, the MMAs over `slots` row slots (default:
    one a live row), or the integer-pipe body, its runs in the balanced
    order, or with `cluster` = C the one-row tile on a cluster of C
    blocks, row by row."""
    if cluster is not None:
        return np.stack([_emulate_cluster_product(x, y, ctx, square, cluster)
                         for x, y in zip(a, b)])
    E = len(a)
    L = ctx.num_limbs
    slots = slots or E
    r, P = cm.POW_RUN, cm.POW_PAD
    ds = -(-2 * L // 32) * 32 + 16
    nr = 2 * L // r
    A = np.zeros((E, L + 2 * P + 1), np.int64)
    A[:, P: P + L] = a
    Bf = A if square else np.zeros((E, max(2 * L, L + 2 * P) + 1), np.int64)
    if not square:
        Bf[:, P: P + L] = b
    T = np.zeros((E, 2 * L), np.int64)
    c1 = np.zeros((E, nr), np.int64)
    c2 = np.zeros((E, nr), np.int64)
    cols = cm._pow_columns(ctx) if body else None
    # The integer pipe takes its runs in the balanced order (a permutation
    # of every run and row; the values do not depend on it).
    order = (range(nr) if cols is not None else
             [k for _, k, e in _balanced(nr, True, E) if e == 0])
    for k in order:
        _put_run(T, _run_columns(A, Bf, L, k * r, square), c1, k)
    _ripple(T, c1, c2, nr)
    T = np.stack([_limb(T, c2, c) for c in range(2 * L)], axis=1)
    flag = np.zeros(E, bool)
    if cols is None:
        # The integer pipe: T_lo, then q, as the accumulator rows' operand;
        # M' and M one padded row each, read by every row.
        const = lambda t: np.broadcast_to(
            np.pad(t.numpy(), (P, P + 1)), (E, L + 2 * P + 1))
        A[:, P: P + L] = T[:, :L]
        H = np.zeros((E, 2 * L), np.int64)
        for _, k, e in _balanced(L // r, False, E):
            if e == 0:
                _put_run(H, _run_columns(A, const(ctx.m_prime), L, k * r,
                                         False), c1, k)
        _ripple(H, c1, c2, L // r)
        A[:, P: P + L] = np.stack([_limb(H, c2, c) for c in range(L)], axis=1)
        for k in range(nr):
            s = _run_columns(A, const(ctx.m), L, k * r, False)
            _put_run(T, s + T[:, k * r: (k + 1) * r], c1, k)
    else:
        wq, wm = cols[0], cols[1]
        cq, cmv = (c.numpy().astype(np.int64) for c in cols[2:])
        C = _walk_mma(_slabwise(wq, 2 * L), _digits(T[:, :L], L, ds, slots))[
            :, :, :E]
        slot = (C[0, :L].T + cq[None, :L]) + ((C[1, :L].T + cq[None, L:]) << 7)
        H = np.zeros((E, 2 * L), np.int64)
        H[:, :L], H[:, L:] = slot & MASK, slot >> 14
        qlo = H[:, :L].copy()
        _split(qlo, H[:, L:], c1, L // r)
        _ripple(qlo, c1, c2, L // r)
        q = np.stack([_limb(qlo, c2, c) for c in range(L)], axis=1)
        C = _walk_mma(_slabwise(wm, 2 * L), _digits(q, L, ds, slots))[:, :, :E]
        u = T + (C[0].T + cmv[None, : 2 * L]) + ((C[1].T + cmv[None, 2 * L:])
                                                 << 7)
        T, H = u & MASK, u >> 14
        _split(T, H, c1, nr)
    _ripple(T, c1, c2, nr, flag, L)
    out = np.stack([_limb(T, c2, L + i) for i in range(L)], axis=1)
    out[:, 0] += flag
    return out


def _span(kind, k, L):
    """The tile's span(): (lo, n), run k's i-blocks of a phase of `kind`
    (0 a b or q M, 1 a a, 2 q)."""
    nl = L // cm.POW_RUN
    hi = min(k, nl - 1)
    if kind == 1:
        hi = min(hi, k >> 1)
    lo = 0 if k < nl else k - nl
    return lo, hi - lo + 1


def _skewed(row):
    """A limb row as the one-row tile skews it: POW_SKEW_PAD zeros either
    side, word y at y + y // 8 (the skipped words zero)."""
    S = cm.POW_SKEW_PAD
    y = np.arange(len(row) + 2 * S)
    out = np.zeros((len(row) + 2 * S) // 8 * 9, np.int64)
    out[y + y // 8] = np.pad(row, (S, S))
    return out


def _piece(As, Bs, c0, b0, nb, square):
    """The tile's piece(): columns c0 ... c0 + kRun - 1 of A * B over the
    nb i-blocks from b0, read from the skewed rows as sblock() reads them
    (A's words from skew(S + i0); B's window word d from c0 - i0 at
    skew(S + c0 - i0) + d, or + d - 1 for d < 0), a squaring's cross terms
    i < c - i doubled; every block's kRun products of a column fit 32
    bits."""
    r, S = cm.POW_RUN, cm.POW_SKEW_PAD
    skew = lambda y: y + (y >> 3)
    i0 = r * np.arange(b0, b0 + nb)[:, None, None]      # [nb, 1, 1]
    ii = np.arange(r)[None, :, None]                    # [1, kRun, 1]
    j = np.arange(r)[None, None, :]                     # [1, 1, kRun]
    d = j - ii                                          # c - i - (c0 - i0)
    a_at = skew(S + i0) + ii
    b_at = skew(S + c0 - i0) + d - (d < 0)
    assert b_at.min() >= 0 and b_at.max() < len(Bs) and a_at.max() < len(As)
    i = i0 + ii                                          # [nb, kRun, 1]
    c = c0 + j
    prod = As[a_at] * Bs[b_at]                           # [nb, kRun, kRun]
    if square:
        prod = prod * (2 * i < c)
    assert prod.sum(axis=1).max() < 1 << 32
    return prod.sum(axis=(0, 1)) << (1 if square else 0)


PLAN_WIDTHS, SLOTS = 64, 3 * 384  # csrc/redc_tile.cuh's kCand, kSlots


def _plan(kind, rank, C, L):
    """The tile's plans(): (g, [(k, lo, n)] own runs) for block rank's own
    runs of a kind (k = rank + C m), g the odd slab width in 1 ... 127 of
    fewest block-steps a thread (at most SLOTS slabs; the widest of
    equals)."""
    runs = L // cm.POW_RUN if kind == 2 else 2 * L // cm.POW_RUN
    own = [(k,) + _span(kind, k, L) for k in range(rank, runs, C)]
    slabs = lambda g: sum(-(-n // g) for _, _, n in own)
    cost = {g: -(-slabs(g) // THREADS) * g
            for g in range(1, 2 * PLAN_WIDTHS, 2) if slabs(g) <= SLOTS}
    return max(g for g in cost if cost[g] == min(cost.values())), own


def _cluster_phase(kind, A, Bf, L, C, square=False, diag=None, addend=None):
    """One phase of the one-row tile over a cluster of C blocks, A and Bf
    skewed rows: block `rank` cuts each own run (k = rank + C m) into
    slabs of g i-blocks, slab q to thread q mod THREADS; each slab's
    partial run normalised into its slot; the owner sums its runs' slots
    (the diagonal, T for q M), normalises them and sends them to every
    block, which ripples each with the carry below it. Every (run,
    i-block) the kind needs is walked exactly once. Returns (x, c2, flag,
    block-steps of the busiest thread)."""
    r = cm.POW_RUN
    nl = L // r
    runs = nl if kind == 2 else 2 * L // r
    row = np.zeros(2 * L, np.int64)
    c1 = np.zeros(runs, np.int64)
    walked = np.zeros((runs, nl), np.int64)
    steps = 0
    for rank in range(C):
        g, own = _plan(kind, rank, C, L)
        slots = []
        for k, lo, n in own:
            for j in range(-(-n // g)):
                b0, nb = lo + j * g, min(g, n - j * g)
                walked[k, b0: b0 + nb] += 1
                s = _piece(A, Bf, k * r, b0, nb, square)
                limbs, carry = [], 0
                for c in range(r):
                    v = int(s[c]) + carry
                    limbs.append(v & MASK)
                    carry = v >> 14
                assert carry < 1 << 25
                slots.append((k, nb, limbs + [carry]))
        assert len(slots) <= SLOTS
        work = np.zeros(THREADS, np.int64)
        for q, (_, nb, _) in enumerate(slots):
            work[q % THREADS] += nb
        steps = max(steps, int(work.max()))
        for k, _, _ in own:
            total = np.sum([sl for kk, _, sl in slots if kk == k], axis=0)
            assert total.max() < 1 << 32
            carry = 0
            for j in range(r):
                c = k * r + j
                v = int(total[j]) + carry
                if diag is not None and c % 2 == 0:
                    v += int(diag[c >> 1]) ** 2
                if addend is not None:
                    v += int(addend[c])
                row[c] = v & MASK
                carry = v >> 14
            c1[k] = carry + int(total[r])
    need = np.zeros_like(walked)
    for k in range(runs):
        v0, n = _span(kind, k, L)
        need[k, v0: v0 + n] = 1
    np.testing.assert_array_equal(walked, need)
    assert c1.max() < 1 << 27
    x = np.zeros(2 * L, np.int64)
    c2 = np.zeros(runs, np.int64)
    flag = False
    for k in range(runs):
        carry = int(c1[k - 1]) if k else 0
        anyv = 0
        for j in range(r):
            v = int(row[k * r + j]) + carry
            x[k * r + j] = v & MASK
            carry = v >> 14
            anyv |= x[k * r + j]
        assert carry <= 1
        c2[k] = carry
        if k < L // r and (anyv or (k + 1 < L // r and carry)):
            flag = True
    return x, c2, flag, steps


def _emulate_cluster_product(a, b, ctx, square, C):
    """The one-row tile's product of row a and b (a a when square) in the
    integer-pipe body, on a cluster of C blocks: a b, q =
    T_lo M' mod R and U = T + q M as cluster phases, the folds and / R as
    the integer-pipe body's."""
    L = ctx.num_limbs
    r = cm.POW_RUN
    pad = lambda t: _skewed(np.asarray(t, np.int64))
    A = pad(a)
    Bf = A if square else pad(b)
    T, c2, _, _ = _cluster_phase(1 if square else 0, A, Bf, L, C,
                                    square, diag=a if square else None)
    limb = lambda x, c: x[c] + (c2[c // r - 1] if c % r == 0 and c else 0)
    T = np.array([limb(T, c) for c in range(2 * L)])
    assert T.max() <= 1 << 14
    q, c2, _, _ = _cluster_phase(2, pad(T[:L]), pad(ctx.m_prime.numpy()), L,
                                 C)
    q = np.array([limb(q, c) for c in range(L)])  # mod R: top carry dropped
    U, c2, flag, _ = _cluster_phase(0, pad(q), pad(ctx.m.numpy()), L, C,
                                    addend=T)
    out = np.array([limb(U, L + i) for i in range(L)])
    out[0] += flag
    return out


@pytest.mark.parametrize("which", ["256", "2048"])
@pytest.mark.parametrize("mxu", [True, False], ids=["mxu", "int"])
def test_kernel_product_walk_equals_plain_redc(which, mxu):
    M = _modulus(which)
    ctx = mg.build_context(M, CPU)
    L = ctx.num_limbs
    R = 1 << (14 * L)
    Rinv = pow(R, -1, M)
    cols = cm._pow_columns(ctx)
    assert cm._pow_columns(ctx) is cols  # packed once per context
    assert all(w.dtype == torch.int32 for w in cols)
    rng = np.random.default_rng(L)
    E = 8
    a = _operands(rng, M, L, E)
    b = _operands(rng, M, L, E)[::-1].copy()
    plain = mg.mont_mul_plain(torch.as_tensor(a), torch.as_tensor(b), ctx)
    for square in (False, True):
        bb = a if square else b
        got = _emulate_product(a, bb, ctx, square, body=mxu)
        want = [x * y * Rinv % M for x, y in zip(hl.limbs_to_ints(a),
                                                 hl.limbs_to_ints(bb))]
        vals = hl.limbs_to_ints(got)
        assert [v % M for v in vals] == want
        assert got.min() >= 0 and got.max() <= 1 << 14
        assert all(100 * v < 101 * M for v in vals)
        if not square:
            assert [v % M for v in hl.limbs_to_ints(plain.numpy())] == want


def _emulate_mont_mul(a, b, ctx, E, rows, shared, cluster=None, body=True):
    """csrc/mont_mul.cu over a batch: block i holds rows i rows ... of a in
    its first live = min(rows, B - i rows) of E row slots, b's matching
    rows (or, shared, b itself in every live slot) as the factor, and runs
    one product in the REDC body `body` (True: int8); with `cluster` = C
    (E = 1, one row a cluster), each row's cluster of C blocks runs it."""
    B, L = a.shape
    out = np.zeros_like(a)
    for e0 in range(0, B, rows):
        live = min(rows, B - e0)
        factor = np.broadcast_to(b, (live, L)) if shared else b[e0: e0 + live]
        out[e0: e0 + live] = _emulate_product(a[e0: e0 + live], factor, ctx,
                                              False, slots=E, cluster=cluster,
                                              body=body)
    return out


@functools.lru_cache(maxsize=None)
def _phe_tpu_products(which, shared, rows, mxu):
    """(M, a, b, phe_tpu's mont_mul or mont_mul_const on them, interpret
    mode, its MXU body or, with mxu False, its integer-pipe one): [rows, L]
    operands below 2.01 M with limbs of exactly 2^14."""
    M = _modulus(which)
    jctx = jmg.build_context(M, mxu=mxu)
    assert (jctx.w_mq is not None) == mxu
    L = jctx.num_limbs
    rng = np.random.default_rng(L + shared)
    a = _operands(rng, M, L, rows)
    b = _operands(rng, M, L, rows)[::-1].copy()
    if shared:
        b = b[1]  # limbs of exactly 2^14 below M's top limb
        got = jpmx.mont_mul_const(jnp.asarray(a.astype(np.uint32)),
                                  jnp.asarray(b.astype(np.uint32)), jctx, tb=8)
    else:
        got = jpmx.mont_mul(jnp.asarray(a.astype(np.uint32)),
                            jnp.asarray(b.astype(np.uint32)), jctx, tb=8)
    return M, a, b, np.asarray(got).astype(np.int64)


# (E, rows a block, B): one and three live rows of E = 8 with a ragged
# last block of 1, full E = 8 blocks and a last block of 1, five live
# rows of E = 32 with a last block of 1, a full E = 32 block and one
# more row; and L = 8 (p of a 128-bit key) at E = 8.
_MUL_BLOCKS = [("256", 8, 1, 3), ("256", 8, 3, 7), ("256", 8, 8, 9),
               ("256", 32, 5, 11), ("256", 32, 32, 33), ("p128", 8, 3, 7),
               ("p128", 32, 32, 33)]


@pytest.mark.parametrize("which,E,rows,B", _MUL_BLOCKS)
@pytest.mark.parametrize("shared", [False, True], ids=["two", "shared"])
@pytest.mark.parametrize("mxu", [True, False], ids=["mxu", "int"])
def test_mont_mul_block_walk_equals_phe_tpu(which, E, rows, B, shared, mxu):
    """The product kernel's blocks, walked in numpy, against phe_tpu's
    Pallas mont_mul / mont_mul_const (interpret mode) with the same REDC
    body, the plain product and Python ints, in value mod M with the
    contract's bounds."""
    M, a, b, want_limbs = _phe_tpu_products(which, shared, 33, mxu)
    a, want_limbs = a[:B], want_limbs[:B]
    if not shared:
        b = b[:B]
    ctx = mg.build_context(M, CPU)
    L = ctx.num_limbs
    assert L == {"256": 40, "p128": 8}[which]
    got = _emulate_mont_mul(a, b, ctx, E, rows, shared, body=mxu)
    Rinv = pow(1 << (14 * L), -1, M)
    ys = hl.limbs_to_ints(np.broadcast_to(b, a.shape))
    want = [x * y * Rinv % M for x, y in zip(hl.limbs_to_ints(a), ys)]
    vals = hl.limbs_to_ints(got)
    assert [v % M for v in vals] == want
    assert [v % M for v in hl.limbs_to_ints(want_limbs)] == want
    plain = (cm.mont_mul_const(torch.as_tensor(a), torch.as_tensor(b), ctx)
             if shared else
             cm.mont_mul(torch.as_tensor(a), torch.as_tensor(b), ctx))
    assert [v % M for v in hl.limbs_to_ints(plain.numpy())] == want
    assert got.min() >= 0 and got.max() <= 1 << 14
    assert all(100 * v < 101 * M for v in vals)


# (which, C, B): batches of the one-row tile, each row on a cluster of C.
_CLUSTER_BLOCKS = [("256", 8, 3), ("256", 2, 5), ("256", 1, 2),
                   ("p128", 8, 4), ("p128", 1, 3)]


@pytest.mark.parametrize("which,C,B", _CLUSTER_BLOCKS)
@pytest.mark.parametrize("shared", [False, True], ids=["two", "shared"])
def test_mont_mul_cluster_walk_equals_phe_tpu(which, C, B, shared):
    """The product kernel's one-row tile (integer pipe), each row on a
    cluster of C blocks, walked in numpy against phe_tpu's Pallas
    integer-pipe mont_mul / mont_mul_const (interpret mode), the plain
    product and Python ints, in value mod M with the contract's bounds."""
    M, a, b, want_limbs = _phe_tpu_products(which, shared, 33, False)
    a, want_limbs = a[:B], want_limbs[:B]
    if not shared:
        b = b[:B]
    ctx = mg.build_context(M, CPU)
    L = ctx.num_limbs
    got = _emulate_mont_mul(a, b, ctx, 1, 1, shared, cluster=C)
    Rinv = pow(1 << (14 * L), -1, M)
    ys = hl.limbs_to_ints(np.broadcast_to(b, a.shape))
    want = [x * y * Rinv % M for x, y in zip(hl.limbs_to_ints(a), ys)]
    vals = hl.limbs_to_ints(got)
    assert [v % M for v in vals] == want
    assert [v % M for v in hl.limbs_to_ints(want_limbs)] == want
    plain = mg.mont_mul_plain(torch.as_tensor(a), torch.as_tensor(b), ctx)
    assert [v % M for v in hl.limbs_to_ints(plain.numpy())] == want
    assert got.min() >= 0 and got.max() <= 1 << 14
    assert all(100 * v < 101 * M for v in vals)


@functools.lru_cache(maxsize=None)
def _phe_tpu_int_products(which):
    """(M, a, b, phe_tpu's integer-pipe mont_mul of a, b and of a, a):
    three rows below 2.01 M (zero, limbs of 2^14, redundant limbs),
    phe_tpu's Pallas kernel in interpret mode on a context without REDC
    matrices."""
    M = _modulus(which)
    jctx = jmg.build_context(M, mxu=False)
    assert jctx.w_mq is None
    L = jctx.num_limbs
    rng = np.random.default_rng(L)
    a = _operands(rng, M, L, 3)
    b = _operands(rng, M, L, 3)[::-1].copy()
    outs = [np.asarray(jpmx.mont_mul(jnp.asarray(a.astype(np.uint32)),
                                     jnp.asarray(y.astype(np.uint32)), jctx,
                                     tb=8)).astype(np.int64) for y in (b, a)]
    return M, a, b, outs


# The limb engine's widths: a 128-bit key's p (L = 8), the fixed 2048-bit
# key's p, p^2 and n^2 (80, 152, 296) and the 8192-bit key's n^2 (1,176).
_CLUSTER_WIDTHS = [("p128", 8), ("p2048", 80), ("pp2048", 152),
                   ("2048", 296), ("8192", 1176)]


@pytest.mark.parametrize("which,L", _CLUSTER_WIDTHS)
@pytest.mark.parametrize("C", [1, 2, 8])
def test_cluster_product_walk_equals_plain_redc_and_phe_tpu(which, L, C):
    """The one-row integer tile's product on a cluster of C blocks, walked
    in numpy as csrc/redc_tile.cuh runs it (each block's chunks of its own
    runs' i-blocks, the pieces' normalised limbs and carries added by
    atomics, the owners' settle, the gather through distributed shared
    memory, the integer pipe's folds and / R), for a plain product and a
    squaring: value-equal mod M to Python ints, to the plain REDC and to
    phe_tpu's Pallas integer-pipe product (interpret mode, a matrix-less
    context), limbs in [0, 2^14], value < 1.01 M."""
    M, a, b, theirs = _phe_tpu_int_products(which)
    ctx = mg.build_context(M, CPU)
    assert ctx.num_limbs == L
    Rinv = pow(1 << (14 * L), -1, M)
    for square, y, their in ((False, b, theirs[0]), (True, a, theirs[1])):
        got = _emulate_product(a, y, ctx, square, cluster=C)
        want = [u * v * Rinv % M for u, v in zip(hl.limbs_to_ints(a),
                                                 hl.limbs_to_ints(y))]
        plain = mg.mont_mul_plain(torch.as_tensor(a), torch.as_tensor(y), ctx)
        for out in (got, their, plain.numpy()):
            assert [v % M for v in hl.limbs_to_ints(out)] == want
        vals = hl.limbs_to_ints(got)
        assert got.min() >= 0 and got.max() <= 1 << 14
        assert all(100 * v < 101 * M for v in vals)


@pytest.mark.parametrize("L,live", [(80, 32), (152, 32), (296, 32), (296, 8),
                                    (440, 8), (1176, 4), (1176, 8)])
def test_balanced_order_covers_every_job_and_evens_the_threads(L, live):
    """The integer pipe's balanced() over E = 8 or 32 row slots: every
    (run, row) of a phase exactly once (a b and q M's tent of 2L / kRun
    runs, q's triangle of L / kRun), and the busiest thread's i-blocks
    (its runs' column heights) no more than under the plain order (job
    idx to run idx / live, thread idx mod 384) and within one run of an
    equal share; the paths' q phases strictly fewer at E = 32."""
    nl = L // cm.POW_RUN
    for runs, tent in ((2 * nl, True), (nl, False)):
        cost = [_span(0 if tent else 2, k, L)[1] for k in range(runs)]
        new = np.zeros(THREADS, np.int64)
        for t, k, _ in _balanced(runs, tent, live):
            new[t] += cost[k]
        old = np.zeros(THREADS, np.int64)
        for idx in range(runs * live):
            old[idx % THREADS] += cost[idx // live]
        share = -(-sum(cost) * live // THREADS)
        assert new.max() <= old.max()
        assert new.max() <= share + max(cost)
        if not tent and live == 32 and L >= 152:
            assert new.max() < old.max()


@pytest.mark.parametrize("which", ["256", "2048"])
def test_pack_blocks_round_trips_the_redc_matrices(which):
    ctx = mg.build_context(_modulus(which), CPU)
    L = ctx.num_limbs
    mats = mg.redc_matrices(ctx)
    Kp = -(-2 * L // 32) * 32
    for w, rows in ((mats.w_mq, L), (mats.w_m, 2 * L)):
        packed = cuda_rns.pack_blocks(w, 2)
        Rp = -(-rows // 16) * 16
        assert tuple(packed.shape) == (Rp // 16 * (Kp // 32), 2, 32, 4)
        back = cuda_rns.unpack_blocks(packed, 2 * L).reshape(2, Rp, Kp)
        assert torch.equal(back[:, :rows, : 2 * L], w.reshape(2, rows, 2 * L))
        assert not back[:, rows:].any() and not back[:, :, 2 * L:].any()
        C = _walk_mma(_slabwise(packed, 2 * L),
                      np.eye(Kp, dtype=np.int64)[: 2 * L])
        np.testing.assert_array_equal(
            C[:, :rows, :].reshape(2 * rows, 2 * L),
            w.numpy().astype(np.int64))


def test_pow_elems_and_smem_fit_the_path_shapes():
    # Every L the limb engine runs (multiples of 8 up to the 8192-bit n^2)
    for L in range(16, 1177, 8):
        for B in (1, 7, 9, 512, 16384):
            e, rows, cluster = cm._pow_elems(L, B, H100_SMS)
            assert e in cm.POW_ELEMS and cm._pow_smem(L, e) <= cm.MAX_SMEM
            assert 1 <= rows <= e and cluster == 1
            if rows < e:
                # Spread: the fewest rows a block whose blocks take one
                # wave and stream no more than POW_STREAM a product.
                fits = lambda r: (-(-B // r) <= H100_SMS and
                                  -(-B // r) * 12 * L * L <= cm.POW_STREAM)
                assert fits(rows) and (rows == 1 or not fits(rows - 1))
    # The paths' shapes, as csrc/mont_pow.cu's note gives them.
    assert cm._pow_smem(296, 32) == 232448 == cm.MAX_SMEM
    assert cm._pow_smem(1176, 8) == 227072
    assert cm._pow_smem(1176, 32) > cm.MAX_SMEM
    assert cm._pow_smem(304, 32) > cm.MAX_SMEM
    assert cm._pow_elems(296, 16384, H100_SMS) == (32, 32, 1)
    assert cm._pow_elems(296, 1, H100_SMS) == (8, 1, 1)
    assert cm._pow_elems(1176, 512, H100_SMS) == (8, 8, 1)  # the stream
    assert cm._pow_elems(296, 512, H100_SMS) == (8, 4, 1)
    assert cm._pow_elems(1176, 16, H100_SMS) == (8, 1, 1)
    assert cm._pow_elems(592, 64, H100_SMS) == (8, 1, 1)
    for sms in (H100_SMS, 114):
        assert [cm._pow_elems(40, B, sms)
                for B in (1, 2 * sms + 1, (sms - 1) * 8 + 1, (sms - 1) * 32,
                          (sms - 1) * 32 + 1)] == [
            (8, 1, 1), (8, 3, 1), (8, 8, 1), (8, 8, 1), (32, 32, 1)]
    for B in (1, 8, 9, 265, 4225):
        e, rows, _ = cm._pow_elems(296, B, H100_SMS)
        tab = cm._pow_table(B, rows, 4, 296, "meta")
        assert tab.shape[0] % rows == 0 and B <= tab.shape[0] < B + rows
        assert tuple(tab.shape[1:]) == (16, 296)


# Every L the port's contexts reach: the half-width contexts of 128-bit
# keys (8) up to the 8192-bit key's n^2 (1,176), among them the 2048-bit
# key's p, p^2, n^2 (80, 152, 296), the 3072-bit key's n^2 (440) and the
# 8192-bit key's p^2 (592).
_PATH_LIMBS = (8, 16, 24, 40, 80, 152, 296, 440, 592, 1176)


@pytest.mark.parametrize("L", _PATH_LIMBS)
def test_tile_chooser_and_smem_fit_every_path_width(L):
    for B in (1, 7, 9, 33, 512, 1024, 16384):
        e, rows, cluster = cm._pow_elems(L, B, H100_SMS)
        assert e in cm.POW_ELEMS and cm._pow_smem(L, e) <= cm.MAX_SMEM
        assert 1 <= rows <= e and cluster == 1
        # E = 32 wherever it fits and its blocks cover the card.
        wide = cm._pow_smem(L, 32) <= cm.MAX_SMEM
        assert (e == 32) == (wide and -(-B // 32) >= H100_SMS)
    assert L <= cm.MAX_MUL_LIMBS
    assert cm._pow_elems(L, 16384, H100_SMS) == ((32, 32, 1) if L <= 296
                                                 else (8, 8, 1))


@pytest.mark.parametrize("L", _PATH_LIMBS)
def test_int_tile_chooser_and_smem_fit_every_path_width(L):
    """The integer-pipe body's (E, rows, C): a batch of more rows than SMs
    as the int8 body's blocks (without the matrix stream's floor); one of
    at most `sms` rows on the one-row tile (E = 1), C the largest power of
    two up to 8 with B C <= sms, so 16 rows take 8 SMs a row (128 of 132);
    every layout fits."""
    assert cm._pow_smem(L, 1, False) <= cm.MAX_SMEM
    for B in (1, 7, 9, 16, 17, 33, 66, 67, 131, 132, 133, 264, 512, 1024,
              16384):
        e, rows, C = cm._pow_elems(L, B, H100_SMS, False)
        assert e in cm.INT_ELEMS and cm._pow_smem(L, e, False) <= cm.MAX_SMEM
        if B <= H100_SMS:
            assert (e, rows) == (1, 1) and C & (C - 1) == 0
            assert B * C <= H100_SMS
            assert C == cm.CLUSTER_MAX or 2 * B * C > H100_SMS
        else:
            assert C == 1 and 1 <= rows <= e
            assert -(-B // rows) <= H100_SMS or rows == e
            wide = cm._pow_smem(L, 32, False) <= cm.MAX_SMEM
            assert (e == 32) == (wide and -(-B // 32) >= H100_SMS)
    assert cm._pow_elems(L, 16, H100_SMS, False) == (1, 1, 8)
    tab = cm._pow_table(16, 1, 4, L, "meta", cluster=8)
    assert tuple(tab.shape) == (128, 16, L)  # a table a block
    # What the card holds at once: 15 clusters of 8, so 16 rows take
    # clusters of 4 (one wave); 15 rows and fewer, clusters of 8.
    fit = H100_FIT.get
    assert [cm._pow_elems(L, B, H100_SMS, False, fit)[2]
            for B in (1, 15, 16, 30, 31, 66, 67)] == [8, 8, 4, 4, 2, 2, 1]
    for B in range(1, H100_SMS + 1):
        C = cm._pow_elems(L, B, H100_SMS, False, fit)[2]
        assert B <= fit(C) and B * C <= H100_SMS
        assert C == 8 or not (B <= fit(2 * C) and 2 * B * C <= H100_SMS)
    if L == 1176:
        assert cm._pow_elems(L, 512, H100_SMS, False) == (8, 4, 1)
        assert cm._pow_smem(L, 1, False) == 124392 > cm.ONE_ROW_BYTES
        assert cm._pow_smem(L, 8, False) == 217640
    if L == 296:
        assert cm._pow_smem(L, 32, False) == 215080


# The REDC body that was the faster for the modexps (both forms, 64-bit
# exponents, and the 8192-bit r^n) in the two-body sweep on an H100 SXM
# (PERF.md, section 6), at each (L, B) a FedAvg cell launches: True for
# the int8 body.
_SWEEP_WINNERS = {
    (80, 64): True, (80, 512): True, (80, 4096): True, (80, 16384): True,
    (152, 64): False, (152, 4096): True, (152, 16384): True,
    (296, 64): False, (296, 512): False, (296, 4096): False,
    (296, 16384): True, (440, 64): False, (440, 512): False,
    (440, 4096): False, (440, 16384): False, (592, 64): False,
    (592, 512): False, (592, 4096): False, (592, 16384): False,
    (1176, 16): False, (1176, 64): False, (1176, 512): False,
    (1176, 4096): False, (1176, 16384): False}


def _bare_modulus(L):
    """An odd modulus whose Montgomery context takes L limbs."""
    return (1 << (14 * L - 30)) + 1


@pytest.mark.parametrize("B", [1, 16, 64, 512, 4096, 16384])
@pytest.mark.parametrize("L", _PATH_LIMBS)
def test_body_rule_follows_the_shape_alone(monkeypatch, L, B):
    """cuda_modexp._body(L, B, sms) is a function of the launch's shape
    and the card's SMs alone, and it gives the body the sweep measured
    the faster for the modexps at every shape it ran (_SWEEP_WINNERS:
    int8 at 16,384 rows and L = 152 and 296, the integer pipe at L = 1,176
    on 512 and 16 rows). A launch's REDC constants follow it (the packed
    matrices, or M' and M), and the launch helpers' private body argument
    holds either body."""
    import inspect

    assert list(inspect.signature(cm._body).parameters) == ["L", "B", "sms"]
    got = cm._body(L, B, H100_SMS)
    assert isinstance(got, bool)
    if (L, B) in _SWEEP_WINNERS:
        assert got == _SWEEP_WINNERS[L, B]
    # The rule as documented: blocks of 32 rows where they fit; smaller
    # blocks only at small L; the one-row cluster tile's batches only at
    # L <= 128.
    E, rows, _ = cm._pow_elems(L, B, H100_SMS)
    if B > H100_SMS and rows == 32:
        assert got
    if L >= 440:
        assert not got
    if B <= H100_SMS:
        assert got == (L <= cm.BODY_ONE_ROW_LIMBS)
    monkeypatch.setattr(cuda_rns, "_sms", lambda device: H100_SMS)
    cols = (torch.zeros(1, dtype=torch.int32),) * 4
    monkeypatch.setattr(cm, "_pow_columns", lambda ctx: cols)
    ctx = mg.build_context(_bare_modulus(L), CPU)
    assert ctx.num_limbs == L
    int8 = (True, tuple(t.data_ptr() for t in cols))
    integer = (False, (ctx.m_prime.data_ptr(), ctx.m.data_ptr()))
    assert cm._redc_args(ctx, CPU, L, B) == (int8 if got else integer)
    assert cm._redc_args(ctx, CPU, L, B, body=True) == int8
    assert cm._redc_args(ctx, CPU, L, B, body=False) == integer


def _launch_tiles(L, B, body):
    """The ints an entry point of either kernel takes before L at a launch
    of B rows at L on an H100 (the integer pipe's clusters as many as it
    holds at once): (B, rows) for the int8 body, (B, rows, C) for the
    integer pipe."""
    _, rows, C = cm._pow_elems(L, B, H100_SMS, body,
                               None if body else H100_FIT.get)
    return (B, rows) if body else (B, rows, C)


def _entry_point(calls, int8, integer):
    """A stand-in for _lib or _pow_lib: each entry point records (its
    form's flag, body, E) and the ints it was given before the stream,
    and answers 0 only for its own body's arguments. int8 and integer:
    each body's (pointers, arguments)."""
    def lib(flag, elems, body):
        pointers, count = int8 if body else integer
        def fn(*args):
            if len(args) != count:
                return 1
            calls.append((flag, body, elems) + args[pointers:-1])
            return 0
        return fn
    return lib


@pytest.mark.parametrize("mxu", [True, False], ids=["mxu", "int"])
def test_mont_mul_limits_and_launch_tiles(monkeypatch, mxu):
    """MAX_MUL_LIMBS is the widest L whose E = 8 block fits, for either
    body; the wrapper launches the entry point of the body _body picks at
    the launch's shape (mxu; int: the integer pipe at every shape, held
    by the launch's private body argument) at the chosen E with the
    chosen rows (the packed matrices, or M' and M), counts one launch a
    call under its body's name, and refuses a width it cannot hold. At
    L = 40 _body takes the int8 body at every batch, at L = 1,176 the
    integer pipe."""
    for body in (True, False):
        assert cm._pow_smem(cm.MAX_MUL_LIMBS, 8, body) <= cm.MAX_SMEM
        assert cm._pow_smem(cm.MAX_MUL_LIMBS + 8, 8, True) > cm.MAX_SMEM
    calls = []
    # The pointers, then (B, rows[, C], L, stream).
    monkeypatch.setattr(cm, "_lib", _entry_point(calls, (7, 11), (5, 10)))
    monkeypatch.setattr(cm._build, "stream_handle", lambda device: None)
    monkeypatch.setattr(cuda_rns, "_sms", lambda device: H100_SMS)
    # The clusters an H100 holds at once (cudaOccupancyMaxActiveClusters).
    monkeypatch.setattr(cm, "_fit", lambda kernel, dev, L: H100_FIT.get)
    for name in cm.FORMS[:2]:
        for suffix in ("", "_int"):
            monkeypatch.setitem(cm.launches, name + suffix, 0)
    batches = (1, 9, 2 * H100_SMS + 1, 32 * H100_SMS + 1)
    want = []
    held = None if mxu else False
    contexts = {L: mg.build_context(_modulus(which), CPU)
                for which, L in (("256", 40), ("8192", 1176))}
    for L, ctx in contexts.items():
        for B in batches:
            a = torch.zeros((B, L), dtype=torch.int64)
            cm._launch(a, a, ctx, shared=False, body=held)
            cm._launch(a, a[0], ctx, shared=True, body=held)
            body = mxu and L == 40
            assert body == (mxu and cm._body(L, B, H100_SMS))
            want += [(shared, body, cm._pow_elems(L, B, H100_SMS, body)[0])
                     + _launch_tiles(L, B, body) + (L,)
                     for shared in (False, True)]
    assert calls == want
    # The integer pipe runs batches of at most 132 rows on the one-row
    # tile, in clusters of 8 blocks a row (1 and 9 rows); its E = 8 tile
    # holds 3 rows a block at 265 rows and L = 1,176; the int8 body's
    # one row a block of E = 8, 3 rows at 265 and E = 32 at 4,225 rows.
    assert ((False, True, 8, 1, 1, 40) in calls and
            (True, True, 8, 265, 3, 40) in calls and
            (False, True, 32, 4225, 32, 40) in calls) if mxu else (
        (False, False, 1, 9, 1, 8, 40) in calls and
        (True, False, 32, 4225, 32, 1, 40) in calls)
    assert (False, False, 8, 265, 3, 1, 1176) in calls
    assert (True, False, 1, 9, 1, 8, 1176) in calls
    int8 = 4 if mxu else 0
    assert cm.launches["mont_mul"] == cm.launches["mont_mul_const"] == int8
    assert (cm.launches["mont_mul_int"] == cm.launches["mont_mul_const_int"]
            == 8 - int8)
    ctx = contexts[40]
    a = torch.zeros((2, 40), dtype=torch.int64)
    with pytest.raises(ValueError, match="limb count"):
        cm._launch(a[:, :32].contiguous(), a[:, :32].contiguous(), ctx, False)
    with pytest.raises(ValueError, match="shape"):
        cm._launch(a, a, ctx, shared=True)


@pytest.mark.parametrize("mxu", [True, False], ids=["mxu", "int"])
def test_mont_pow_launch_tiles_and_bodies(monkeypatch, mxu):
    """The modexp's twin of the product's launch test: both forms launch
    the entry point of the body _body picks at the launch's shape (mxu;
    int: the integer pipe at every shape, held by the launch's private
    body argument), at the chosen E, rows and clusters, with the table
    scratch those imply, counted once a call under the body's name; the
    private body argument holds either body. At L = 296 (the 2048-bit
    key's n^2) _body takes the int8 body at 4,225 rows (blocks of 32) and
    the integer pipe at 512 and 16; at L = 1,176 the integer pipe at 512
    rows (the 8192-bit encrypt's r^n, 4 rows a block of E = 8) and at
    16."""
    calls, tables = [], []
    # The pointers, then (B, rows[, C], L, windows, window, stream).
    monkeypatch.setattr(cm, "_pow_lib", _entry_point(calls, (9, 15),
                                                     (7, 14)))
    monkeypatch.setattr(cm._build, "stream_handle", lambda device: None)
    monkeypatch.setattr(cuda_rns, "_sms", lambda device: H100_SMS)
    monkeypatch.setattr(cm, "_fit", lambda kernel, dev, L: H100_FIT.get)
    table = cm._pow_table
    # (B, rows, window, L, device, C): the scratch is made on "meta".
    monkeypatch.setattr(cm, "_pow_table", lambda *args: tables.append(
        args[:4] + args[5:]) or table(*args[:4], "meta", *args[5:]))
    for name in cm.FORMS[2:]:
        for suffix in ("", "_int"):
            monkeypatch.setitem(cm.launches, name + suffix, 0)
    want, bodies = [], []
    held = None if mxu else False
    for bits, L, batches in ((2048, 296, (16, 512, 32 * H100_SMS + 1)),
                             (8192, 1176, (16, 512))):
        ctx = mg.build_context(_modulus(str(bits)), CPU)
        assert ctx.num_limbs == L
        for B in batches:
            base = torch.zeros((B, L), dtype=torch.int64)
            body = mxu and cm._body(L, B, H100_SMS)
            bodies.append((L, B, body))
            for vec in (False, True):
                cm._pow_launch(base, np.ones((B, 3), np.int8) if vec
                               else [1, 2, 3], ctx, 4, vec, held)
                want.append((vec, body,
                             cm._pow_elems(L, B, H100_SMS, body)[0])
                            + _launch_tiles(L, B, body) + (L, 3, 4))
        base = torch.zeros((512, L), dtype=torch.int64)
        if mxu:
            # The private argument holds the int8 body where _body takes
            # the integer pipe, and the integer pipe where it takes int8.
            for body in (True, False):
                cm._pow_launch(base, [1], ctx, 4, False, body=body)
                want.append((False, body, 8) + _launch_tiles(L, 512, body)
                            + (L, 1, 4))
    assert calls == want
    assert bodies == [(296, 16, False), (296, 512, False), (296, 4225, mxu),
                      (1176, 16, False), (1176, 512, False)]
    # The 8192-bit r^n's tile in either body: 128 blocks of 4 rows on the
    # integer pipe, 64 blocks of 8 on the int8 body.
    assert (False, False, 8, 512, 4, 1, 1176, 3, 4) in calls
    assert ((False, True, 8, 512, 8, 1176, 1, 4) in calls) == mxu
    # One table a launch: 2^window rows of L words for each row slot of
    # each block, a copy a cluster block on the integer pipe's one-row
    # tile (16 rows: clusters of 4 on an H100).
    assert tables == [(c[3], c[4], 4, c[-3]) + ((c[5],) if not c[1]
                                               else (1,)) for c in calls]
    assert tables[0] == (16, 1, 4, 296, 4)
    assert cm.launches == dict(cm.launches, **(
        {"mont_pow_shared": 3, "mont_pow": 1, "mont_pow_shared_int": 6,
         "mont_pow_int": 4} if mxu else
        {"mont_pow_shared": 0, "mont_pow": 0, "mont_pow_shared_int": 5,
         "mont_pow_int": 5}))
