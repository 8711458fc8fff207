"""Batched Montgomery products and modexps: the CUDA kernels and their
plain versions.

The counterpart of phe_tpu/ops/pallas_modexp.py. ``mont_mul`` and
``mont_mul_const`` (``mont_mul_cols``, ``mont_mul_const_cols``) launch the
kernel of ``csrc/mont_mul.cu``; ``mont_pow_shared`` and ``mont_pow``
(``mont_pow_shared_cols``, ``mont_pow_cols``: the windowed modexp with an
exponent shared by the batch or one per row) launch the kernel of
``csrc/mont_pow.cu``. Both run the REDC tile of ``csrc/redc_tile.cuh``: E
rows a block (``_pow_elems``), both constant products of each reduction
either on the int8 tensor cores against the context's REDC matrices,
packed once per context and card (``_pow_columns``), or on the CUDA
cores' integer pipe against M' and M (the ``_int`` entry points), whose
batches no larger than the card's SMs run one row a thread-block cluster
of C blocks (E = 1). Each launch takes the body that ``_body`` finds the
faster at its shape (L, B) on the card. Each launches its kernel for
tensors on the card and takes its plain PyTorch version
(montgomery.mont_mul_plain, mont_pow_shared_plain, mont_pow_plain: the
integer-pipe formulation) for tensors on the CPU; any other device
raises.

The contract (phe_tpu's tests state it for its kernels): for inputs below
2.01 M with limbs in [0, 2^14], the output is congruent to a*b*R^-1 mod M
(x^e R mod M for the modexps, with x in Montgomery form), has limbs in
[0, 2^14] and value < 1.01 M. Kernel and plain version agree in value mod
M, not necessarily limb for limb. The products take L from 8 to
MAX_MUL_LIMBS (1,200: the widest whose E = 8 block fits), the modexps
from 16.

``table_select`` launches the kernel of ``csrc/table_select.cu``: the
shared-table matvec's constant-time select of windowed-table rows
(batch._matvec); its plain version, ``table_select_plain``, indexes
the tables.

``launches`` counts the kernel launches of each form and body (the
integer-pipe ones under ``<form>_int``, the select under
``table_select``); nothing else changes it.
"""

import ctypes

import torch
from torch.utils.weak import WeakIdKeyDictionary

from phe_tpu_torch.ops import _build
from phe_tpu_torch.ops import cuda_rns
from phe_tpu_torch.ops import montgomery as mg

# The dynamic shared memory a block can have on Hopper (227 KB); a block
# of either kernel takes _pow_smem(L, E).
MAX_SMEM = 232448
# The widest L (a multiple of 8) whose block of E = 8 rows fits MAX_SMEM.
MAX_MUL_LIMBS = 1200
FORMS = ("mont_mul", "mont_mul_const", "mont_pow_shared", "mont_pow")
launches = {name + body: 0 for body in ("", "_int") for name in FORMS}
launches["table_select"] = 0
# Rows a modexp block holds: the kernel's instantiations, widest first.
POW_ELEMS = (32, 8)
# The integer-pipe body's also the one-row tile (E = 1), each row on a
# thread-block cluster of at most CLUSTER_MAX blocks (the portable size).
INT_ELEMS = POW_ELEMS + (1,)
CLUSTER_MAX = 8
# The one-row tile's skewed rows: POW_SKEW_PAD zero words either side; and
# the least shared memory its block asks for (over half an SM's, so that
# no two blocks share one).
POW_SKEW_PAD, ONE_ROW_BYTES = 16, 116736
# REDC matrix bytes (12 L^2 a block) that the blocks of one launch may
# stream from L2 for each product before more blocks stop paying: the
# 8192-bit encrypt's 64 blocks at L = 1,176 (1.06 GB) ran no faster
# spread over 128, while 64 blocks at L = 592 (0.27 GB) ran faster than
# 8 (PERF.md, section 6).
POW_STREAM = 1 << 29
# The REDC body rule's limbs (_body): the int8 body up to BODY_ROW_LIMBS
# times the rows its blocks hold, and up to BODY_ONE_ROW_LIMBS for the
# batches the integer pipe runs on its one-row tile.
BODY_ROW_LIMBS, BODY_ONE_ROW_LIMBS = 24, 128
# Per context (keyed by its m tensor): the kernels' packed REDC operands
# on its card, built at its first int8-body launch of either kernel.
_pow_packed = WeakIdKeyDictionary()
# (kernel, device index, L, C) -> the clusters of C blocks of the one-row
# tile the card holds at once (cudaOccupancyMaxActiveClusters).
_fits = {}

mont_mul_plain = mg.mont_mul_plain


def _entry(lib, name, pointers, ints):
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _lib(shared, elems, mxu=True):
    """The Montgomery-product kernel's C entry point for one form, one E
    and one REDC body."""
    lib = _build.load("mont_mul")
    if lib.phe_mont_mul_smem.argtypes is None:
        for e in POW_ELEMS:
            for form in ("phe_mont_mul_%d", "phe_mont_mul_const_%d"):
                _entry(lib, form % e, 7, 3)
        for e in INT_ELEMS:
            for form in ("phe_mont_mul_int_%d", "phe_mont_mul_const_int_%d"):
                _entry(lib, form % e, 5, 4)
        lib.phe_mont_mul_smem.argtypes = [ctypes.c_int] * 3
        lib.phe_mont_mul_smem.restype = ctypes.c_int
        lib.phe_mont_mul_clusters.argtypes = [ctypes.c_int] * 2
        lib.phe_mont_mul_clusters.restype = ctypes.c_int
    return getattr(lib, "phe_mont_mul%s%s_%d" % (
        "_const" if shared else "", "" if mxu else "_int", elems))


def _pow_lib(vec, elems, mxu=True):
    """The modexp kernel's C entry point for one form, one E and one REDC
    body."""
    lib = _build.load("mont_pow")
    if lib.phe_mont_pow_smem.argtypes is None:
        for e in POW_ELEMS:
            for form in ("phe_mont_pow_%d", "phe_mont_pow_shared_%d"):
                _entry(lib, form % e, 9, 5)
        for e in INT_ELEMS:
            for form in ("phe_mont_pow_int_%d", "phe_mont_pow_shared_int_%d"):
                _entry(lib, form % e, 7, 6)
        lib.phe_mont_pow_smem.argtypes = [ctypes.c_int] * 3
        lib.phe_mont_pow_smem.restype = ctypes.c_int
        lib.phe_mont_pow_clusters.argtypes = [ctypes.c_int] * 2
        lib.phe_mont_pow_clusters.restype = ctypes.c_int
    return getattr(lib, "phe_mont_pow%s%s_%d" % (
        "" if vec else "_shared", "" if mxu else "_int", elems))


# csrc/redc_tile.cuh's geometry: kRun columns a job, kPad zero limbs
# either side of an operand row, and the MMA phases' ring of A fragments
# (kWarps x kStages slots of 1 KB).
POW_RUN, POW_PAD, POW_RING = 8, 14, 12 * 4 * 1024


def _pow_smem(L, elems, mxu=True):
    """Shared-memory bytes of one block of either kernel (csrc/redc_tile.cuh's
    smem_bytes): per row the operand row with its pads (L + 2 kPad + 1
    words) and the two carry arrays (2L / kRun words each), a region the
    int8 body's MMA phases reuse as their ring and never smaller than it
    there; then per row T and the scratch H (2L + 1 words each, H at least
    the padded operand) and the flag; then, for the int8 body (mxu), the
    digit row (2L padded to 32, plus a 16-byte skew) per row, or, for the
    integer-pipe body, the two padded constant rows M' and M and, for its
    one-row tile (elems 1), the cluster words: four skewed rows (L + 2
    POW_SKEW_PAD words, 9 for every 8), 3 words to align, two receiving
    rows (2L) and their carries (2L / kRun), the slabs' slots (3 x 384 of
    9 words), three plans (4 + 2L / kRun + 1) and their 3 x 64
    candidates; at least ONE_ROW_BYTES."""
    rows = 4 * elems * ((L + 2 * POW_PAD + 1) + 2 * (2 * L // POW_RUN))
    words = (2 * L + 1) + (max(2 * L, L + 2 * POW_PAD) + 1) + 1
    if not mxu:
        bytes_ = rows + 4 * elems * words + 8 * (L + 2 * POW_PAD + 1)
        if elems != 1:
            return bytes_
        runs = 2 * L // POW_RUN
        skewed = (L + 2 * POW_SKEW_PAD) // 8 * 9
        plans = 3 * (4 + runs + 1) + 3 * 64
        return max(ONE_ROW_BYTES, bytes_ + 4 * (
            4 * skewed + 3 + 4 * L + 2 * runs + 3 * 384 * 9 + plans))
    return max(rows, POW_RING) + elems * (4 * words + -(-2 * L // 32) * 32
                                          + 16)


def _pow_elems(L, B, sms, mxu=True, fit=None):
    """(E, rows, C) of a product or modexp launch of B rows at L on a card
    of `sms` multiprocessors, for the int8 body (mxu) or the integer-pipe
    one: the instantiation E, the rows each block holds and the blocks of
    each cluster.
    E is the widest instantiation whose shared memory fits and whose
    ceil(B / E) blocks still cover the SMs, a block then holding E rows;
    when none does, the narrowest that fits, its blocks holding
    ceil(B / sms) rows (at most E), so that a small batch spreads over
    the card, but, with mxu, no fewer than keep the blocks' matrix stream
    within POW_STREAM. A fuller block divides the REDC matrices' L2 reads
    by its rows. The window does not enter: the table lives in device
    memory. The stream is per product, so a launch of one product and a
    modexp of many choose alike. C is 1 but for the integer-pipe body's
    batches of at most `sms` rows: those run the one-row tile (E = 1) on
    clusters of C blocks, C the largest power of two up to CLUSTER_MAX
    with B C <= sms and, where fit(C) says how many clusters of C the card
    holds at once, B <= fit(C): one wave. (An H100 holds 15 clusters of 8
    and 30 of 4, so 16 rows take clusters of 4.)"""
    fits = [e for e in POW_ELEMS if _pow_smem(L, e, mxu) <= MAX_SMEM]
    if not fits:
        raise ValueError("no modexp block fits %d bytes of shared memory at "
                         "L = %d" % (MAX_SMEM, L))
    for e in fits:
        if -(-B // e) >= sms:
            return e, e, 1
    rows = -(-B // sms)
    if mxu:
        rows = max(rows, -(-B * 12 * L * L // POW_STREAM))
    elif rows == 1:
        C = 1 << min(CLUSTER_MAX.bit_length() - 1,
                     (sms // B).bit_length() - 1)
        while C > 1 and fit is not None and fit(C) < B:
            C //= 2
        return 1, 1, C
    return fits[-1], min(fits[-1], rows), 1


def _body(L, B, sms):
    """Whether a product or modexp launch of B rows at L on a card of
    `sms` multiprocessors runs the int8 REDC body (True) or the integer
    pipe (False): the int8 body where the modexps measured it the faster
    (PERF.md, section 6).

    Each block of the int8 body streams the two REDC matrices, 12 L^2
    bytes, from L2 once a product, shared by the rows it holds; the
    integer pipe computes q and q M on the CUDA cores instead. The int8
    body ran the modexps faster where that stream a row-product,
    12 L^2 ceil(B / rows) / B bytes, is at most 12 BODY_ROW_LIMBS L:
    every 32-row block, where one fits (L <= 296); 8-row blocks up to
    L = 152; none at L >= 440. A batch of at most `sms` rows, which the
    integer pipe runs one row a cluster of blocks, whose syncs cost most
    at small L, takes the int8 body up to L = BODY_ONE_ROW_LIMBS. A
    product launch follows its modexp: at L <= 152 the integer pipe ran
    single products up to 43 % (0.15 ms) faster, where the int8 body ran
    the modexps up to 49 % faster."""
    if B <= sms:
        return L <= BODY_ONE_ROW_LIMBS
    _, rows, _ = _pow_elems(L, B, sms)
    return L * -(-B // rows) <= BODY_ROW_LIMBS * B


def _pow_columns(ctx):
    """(w_mq, w_m packed in fragment order, c_mq, c_m as int32) on the
    context's device, packed on the host once per context and card; the
    unpacked matrices are not kept."""
    cols = _pow_packed.get(ctx.m)
    if cols is None:
        mats = mg.redc_matrices(ctx)
        cols = _pow_packed[ctx.m] = tuple(
            t.to(ctx.m.device) for t in (
                cuda_rns.pack_blocks(mats.w_mq, 2),
                cuda_rns.pack_blocks(mats.w_m, 2),
                mats.c_mq.to(torch.int32).contiguous(),
                mats.c_m.to(torch.int32).contiguous()))
    return cols


def _fit(kernel, dev, L):
    """fit(C) for _pow_elems: the clusters of C blocks of `kernel`'s
    one-row tile the card holds at once, asked once per (card, L, C)."""
    def fit(C):
        key = (kernel, dev.index, L, C)
        if key not in _fits:
            # _lib and _pow_lib set the library's argument types.
            (_lib if kernel == "mont_mul" else _pow_lib)(False, 1, False)
            got = getattr(_build.load(kernel), "phe_%s_clusters" % kernel)(
                L, C)
            if got < 0:
                raise RuntimeError("%s: cudaOccupancyMaxActiveClusters "
                                   "failed: CUDA error %d" % (kernel, -got))
            _fits[key] = got
        return _fits[key]
    return fit


def _tile(L, B, dev, mxu, kernel):
    """(E, rows, C, the integer ints an entry point takes before L)."""
    elems, rows, cluster = _pow_elems(L, B, cuda_rns._sms(dev), mxu,
                                      None if mxu else _fit(kernel, dev, L))
    return elems, rows, cluster, (B, rows) if mxu else (B, rows, cluster)


def _redc_args(ctx, dev, L, B, body=None):
    """(mxu, the REDC constants' pointers) of a launch of B rows: the
    packed matrices and their compensation vectors for the int8 body, or
    M' and M for the integer pipe. The body is _body's; `body` (the launch
    helpers' private argument, for the card's tests and sweeps) holds it
    to one."""
    if body is None:
        body = _body(L, B, cuda_rns._sms(dev))
    if not body:
        _check(ctx.m_prime, "ctx.m_prime", (L,), dev)
        return False, (ctx.m_prime.data_ptr(), ctx.m.data_ptr())
    return True, tuple(t.data_ptr() for t in _pow_columns(ctx))


def _check(t, name, shape, device):
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != torch.int64:
        raise TypeError("%s must be int64, got %s" % (name, t.dtype))
    if tuple(t.shape) != shape:
        raise ValueError(
            "%s has shape %s, expected %s" % (name, tuple(t.shape), shape)
        )
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def _launch(a, b, ctx, shared, body=None):
    """One launch of the product kernel, E and its rows from _pow_elems,
    the REDC body from _redc_args."""
    if a.dim() != 2:
        raise ValueError("a must be [B, L], got shape %s" % (tuple(a.shape),))
    B, L = a.shape
    if L != ctx.num_limbs or L % 8 or not 8 <= L <= MAX_MUL_LIMBS:
        raise ValueError(
            "limb count %d: need the context's L = %d, a multiple of 8 "
            "from 8 to %d (the widest whose block of 8 rows fits %d bytes "
            "of shared memory)" % (L, ctx.num_limbs, MAX_MUL_LIMBS, MAX_SMEM)
        )
    dev = a.device
    _check(a, "a", (B, L), dev)
    _check(b, "b", (L,) if shared else (B, L), dev)
    _check(ctx.m, "ctx.m", (L,), dev)
    out = torch.empty_like(a)
    if B == 0:
        return out
    mxu, consts = _redc_args(ctx, dev, L, B, body)
    elems, _, _, tile = _tile(L, B, dev, mxu, "mont_mul")
    rc = _lib(shared, elems, mxu)(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), *consts, *tile, L,
        _build.stream_handle(dev),
    )
    if rc != 0:
        raise RuntimeError("mont_mul kernel launch failed: CUDA error %d" % rc)
    launches[("mont_mul_const" if shared else "mont_mul")
             + ("" if mxu else "_int")] += 1
    return out


def _dispatch(a, b, ctx, shared):
    if a.device.type == "cuda":
        return _launch(a, b, ctx, shared)
    if a.device.type == "cpu":
        return mont_mul_plain(a, b, ctx)
    raise ValueError("no Montgomery product for device %s" % a.device)


def mont_mul(a, b, ctx):
    """a*b*R^-1 mod M for a, b [B, L] int64 (value < 1.01 M)."""
    return _dispatch(a, b, ctx, shared=False)


def mont_mul_const(a, b_limbs, ctx):
    """a*b*R^-1 mod M for a [B, L] against one shared b [L]."""
    return _dispatch(a, b_limbs, ctx, shared=True)


def _pow_table(B, rows, window, L, dev, cluster=1):
    """The kernel's table scratch: 2^window rows of L words for each of
    the rows slots of its ceil(B / rows) * cluster blocks (a cluster's
    blocks keep a copy each)."""
    return torch.empty((-(-B // rows) * cluster * rows, 1 << window, L),
                       dtype=torch.int32, device=dev)


def _pow_launch(base, digits, ctx, window, vec, body=None):
    """One launch of the modexp kernel, E and its rows from _pow_elems,
    the REDC body from _redc_args."""
    if base.dim() != 2:
        raise ValueError("base must be [B, L], got shape %s"
                         % (tuple(base.shape),))
    B, L = base.shape
    if L != ctx.num_limbs or L % 8 or L < 16 or not 1 <= window <= 8:
        raise ValueError(
            "limb count %d at window %d: need the context's L = %d (a "
            "multiple of 8, at least 16) and window in [1, 8]"
            % (L, window, ctx.num_limbs)
        )
    dev = base.device
    _check(base, "base", (B, L), dev)
    for name in ("m", "one"):
        _check(getattr(ctx, name), "ctx." + name, (L,), dev)
    if vec:
        digits = cuda_rns._digit_rows_on(digits, window, B, dev)
    else:
        digits = cuda_rns._digits_on(digits, window, dev)
    out = torch.empty_like(base)
    if B == 0:
        return out
    mxu, consts = _redc_args(ctx, dev, L, B, body)
    elems, rows, cluster, tile = _tile(L, B, dev, mxu, "mont_pow")
    table = _pow_table(B, rows, window, L, dev, cluster)
    rc = _pow_lib(vec, elems, mxu)(
        base.data_ptr(), out.data_ptr(), table.data_ptr(),
        ctx.one.data_ptr(), *consts, digits.data_ptr(), *tile, L,
        digits.shape[-1], window, _build.stream_handle(dev),
    )
    name = ("mont_pow" if vec else "mont_pow_shared") + ("" if mxu else "_int")
    if rc != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (name, rc))
    launches[name] += 1
    return out


def mont_pow_shared(base, digits, ctx, window=mg.DEFAULT_WINDOW):
    """base^e R mod M for base [B, L] in Montgomery form; digits
    [n_windows], the MSB-first schedule of e shared by the batch."""
    if base.device.type == "cuda":
        return _pow_launch(base, digits, ctx, window, vec=False)
    if base.device.type == "cpu":
        return mg.mont_pow_shared_plain(base, digits, ctx, window=window)
    raise ValueError("no Montgomery modexp for device %s" % base.device)


def mont_pow(base, digits, ctx, window=mg.DEFAULT_WINDOW):
    """base_i^e_i R mod M for base [B, L] in Montgomery form; digits
    [B, n_windows], one schedule per row (int8 on the card, any integer
    type on the host)."""
    if base.device.type == "cuda":
        return _pow_launch(base, digits, ctx, window, vec=True)
    if base.device.type == "cpu":
        return mg.mont_pow_plain(base, digits, ctx, window=window)
    raise ValueError("no Montgomery modexp for device %s" % base.device)


def table_select_plain(table, digits, neg, i0, dc):
    """Plain version of table_select: the tables indexed."""
    signs = table.shape[1]
    d = torch.as_tensor(digits)[:, i0 : i0 + dc].to(table.device,
                                                     torch.int64)
    s = (neg[:, i0 : i0 + dc].to(torch.int64)[:, :, None] * (signs - 1)
         ).expand(d.shape)
    i = torch.arange(i0, i0 + dc, device=table.device)[None, :, None]
    return table[d, s, i.expand(d.shape)].transpose(0, 1).contiguous()


def _select_launch(table, digits, neg, i0, dc):
    """One launch of the select kernel (csrc/table_select.cu)."""
    if table.dim() != 4 or table.shape[0] != 16 or table.shape[1] not in (
            1, 2):
        raise ValueError("table must be [16, 1 or 2, D, L], got shape %s"
                         % (tuple(table.shape),))
    _, signs, D, L = table.shape
    if digits.dim() != 3 or digits.shape[1] != D:
        raise ValueError("digits must be [B, %d, W], got shape %s"
                         % (D, tuple(digits.shape)))
    B, _, W = digits.shape
    if L % 2 or not 0 <= i0 < i0 + dc <= D:
        raise ValueError("L = %d must be even and bases [%d, %d) inside "
                         "[0, %d)" % (L, i0, i0 + dc, D))
    dev = table.device
    _check(table, "table", (16, signs, D, L), dev)
    for t, name, dtype, shape in ((digits, "digits", torch.int8, (B, D, W)),
                                  (neg, "neg", torch.bool, (B, D))):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError("%s must be a contiguous %s %s on %s, got %s %s "
                             "on %s" % (name, dtype, shape, dev, t.dtype,
                                        tuple(t.shape), t.device))
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    out = torch.empty((dc, B, W, L), dtype=torch.int64, device=dev)
    fn = _build.load("table_select").phe_table_select
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rc = fn(table.data_ptr(), digits.data_ptr(), neg.data_ptr(),
            out.data_ptr(), D, B, W, i0, dc, signs, L,
            _build.stream_handle(dev))
    if rc != 0:
        raise RuntimeError("table_select kernel launch failed: CUDA error %d"
                           % rc)
    launches["table_select"] += 1
    return out


def table_select(table, digits, neg, i0, dc):
    """out[i - i0, j, w] = table[digits[j, i, w], neg[j, i], i] for the
    bases i in [i0, i0 + dc), in constant time: the shared-table matvec's
    factors.

    table: [16, signs, D, L] int64, table[k, s, i] the k-th power of base
    i (s = 0) or of its inverse (s = 1; signs 2 only), limbs in [0, 2^14];
    digits: [B, D, W] int8 schedules at the window of 4 bits; neg: [B, D]
    bool, read only where signs is 2. Returns [dc, B, W, L] int64: the
    kernel for tensors on the card, table_select_plain on the CPU.
    """
    if table.device.type == "cuda":
        return _select_launch(table, digits, neg, i0, dc)
    if table.device.type == "cpu":
        return table_select_plain(table, digits, neg, i0, dc)
    raise ValueError("no table select for device %s" % table.device)
