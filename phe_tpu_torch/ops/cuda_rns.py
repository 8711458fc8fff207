"""The RNS ladders: the CUDA kernel and the dispatch to its plain versions.

The counterpart of phe_tpu/ops/pallas_rns.py's ``ladder_cols`` (exponent
shared by the batch) and ``ladder_vec_cols`` (one exponent per element).
``ladder`` and ``ladder_vec`` launch the kernel of ``csrc/rns_ladder.cu``
for residues on the card and run the plain PyTorch versions,
``rns.ladder_plain`` and ``rns.ladder_vec_plain``, for residues on the CPU;
any other device raises. Every residue is canonical, so kernel and plain
version are bit-equal: the same integers at every step.

The kernel runs both base extensions of each product as int8 tensor-core
products (``mma.sync`` m16n8k32) with the block's elements as the N
dimension, their A fragments streamed through a ring of stages in shared
memory by bulk copies that a cluster of blocks shares. What it needs from
the host lives here, where the CPU tests reach it: the padded geometry
(``_geometry``), the warps a block (``_warps``), the extension matrices
packed in the MMA's A-fragment order stage by stage (``pack_blocks``), the
ring (``_ring``), the block's shared memory (``_smem``), the elements a
block holds (``_elems``), chosen per launch from (k, B) among the kernel's
instantiations, and the blocks a cluster (``CLUSTER``).

``launches`` counts the kernel launches of each form; nothing else
changes it.
"""

import ctypes

import torch
from torch.utils.weak import WeakIdKeyDictionary

from phe_tpu_torch import config
from phe_tpu_torch.ops import _build
from phe_tpu_torch.ops import rns

launches = {"rns_ladder": 0, "rns_ladder_vec": 0}

# The system's [cpad] int64 rows the kernel reads, in its argument order.
_ROWS = ("m", "mu", "t14", "sig1", "sig2", "d1", "d2", "e1", "neg_mb",
         "one_dom")
# Per system, keyed by its w_ext1 tensor: both extension matrices packed
# for the kernel, built at the system's first launch.
_packed = WeakIdKeyDictionary()

# Elements a block holds: the kernel's instantiations, widest first.
ELEMS = (32, 8)
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
# A block's bytes when two share an SM: 228 KB less 1 KB for each block.
PAIR_LIMIT = 115712
MAX_WARPS = 11  # consumer warps a block; one more warp produces
TILE_BYTES = 3 * 512  # a slab's three digit-block tiles at one K-step
MAX_STAGE_STEPS = 4  # K-steps a stage of the ring holds at most
# Blocks of a cluster (csrc/rns_ladder.cu's kCluster), at either E.
CLUSTER = 2


def _lib(vec, elems):
    """The kernel's C entry point for one mode and one E."""
    lib = _build.load("rns_ladder")
    if lib.phe_rns_ladder_smem.argtypes is None:
        for e in ELEMS:
            for form in ("phe_rns_ladder_%d", "phe_rns_ladder_vec_%d"):
                fn = getattr(lib, form % e)
                fn.argtypes = (
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p] * (len(_ROWS) + 6)
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                )
                fn.restype = ctypes.c_int
        lib.phe_rns_ladder_smem.argtypes = [ctypes.c_int] * 2
        lib.phe_rns_ladder_smem.restype = ctypes.c_int
    return getattr(lib, ("phe_rns_ladder_vec_%d" if vec
                         else "phe_rns_ladder_%d") % elems)


def _geometry(k):
    """(K1p, Kp): each extension's output rows k + 8 padded to the MMA's
    16-row slabs, and its depth 2k padded to the MMA's 32-digit K-steps."""
    return -(-(k + 8) // 16) * 16, -(-2 * k // 32) * 32


def _warps(k):
    """Consumer warps a block (csrc/rns_ladder.cu's warps_for): the
    K1p / 16 row slabs spread evenly over at most MAX_WARPS warps, one
    slab a warp in each round."""
    slabs = _geometry(k)[0] // 16
    rounds = -(-slabs // MAX_WARPS)
    return -(-slabs // rounds)


def _base(k, elems):
    """Bytes of the elements' rows: per element one residue row (cpad + 4
    uint32: a 4-word skew) and the digit row (Kp bytes and a 16-byte skew,
    which holds the element's word, S row k and then beta, and one of the
    ring's barriers)."""
    _, Kp = _geometry(k)
    return elems * (4 * (2 * k + 12) + Kp + 16)


def _ring(k, elems):
    """(kc, depth) of the kernel's ring (ring_shape): `depth` stages of kc
    K-steps of a whole round's tiles, as many as the bytes the rows leave
    hold and the digit rows have barriers for (two a slot, one a row), of
    the most K-steps up to MAX_STAGE_STEPS of which two fit. Eight-element
    blocks leave room for a second block on the SM (PAIR_LIMIT). Where not
    even two one-K-step stages fit, (1, 2), which puts _smem past the
    limit."""
    round_bytes = _warps(k) * TILE_BYTES
    left = (PAIR_LIMIT if elems == 8 else SMEM_LIMIT) - _base(k, elems)
    for kc in range(MAX_STAGE_STEPS, 0, -1):
        depth = min(left // (kc * round_bytes), elems // 2)
        if depth >= 2:
            return kc, depth
    return 1, 2


def _smem(k, elems):
    """Shared-memory bytes of one block (csrc/rns_ladder.cu's
    smem_bytes): the ring's stages, then the rows."""
    kc, depth = _ring(k, elems)
    return _base(k, elems) + depth * kc * _warps(k) * TILE_BYTES


def _elems(k, B, sms):
    """Elements a block holds for B rows at k on a card of `sms`
    multiprocessors: the widest instantiation whose shared memory fits and
    whose ceil(B / E) blocks still cover the SMs; when none does, the
    narrowest that fits (the most blocks). Wider blocks divide the
    extension matrices' L2 reads by E."""
    fits = [e for e in ELEMS if _smem(k, e) <= SMEM_LIMIT]
    if not fits:
        raise ValueError("no RNS ladder block fits %d bytes of shared memory "
                         "at k = %d" % (SMEM_LIMIT, k))
    for e in fits:
        if -(-B // e) >= sms:
            return e
    return fits[-1]


def _sms(dev):
    """The streaming multiprocessors of the card `dev`."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _stage_order(S, KS, per):
    """Slab-by-slab tile numbers (s KS + ks) in stage order: rounds of
    `per` slabs (the last maybe fewer), each K-step by K-step, each
    K-step its round's slabs in order."""
    order = []
    for r0 in range(0, S, per):
        nr = min(per, S - r0)
        order += [(r0 + i) * KS + ks for ks in range(KS) for i in range(nr)]
    return torch.as_tensor(order)


def pack_blocks(w, nb, per=1):
    """int8 [nb * rows, K] -> int32 [S KS, nb, 32, 4] in mma.sync's A
    order, tile by tile in stage order.

    The matrix is cut into its nb row blocks (rows b rows ... (b+1) rows),
    each zero-padded to [Rp, Kp] (rows to the MMA's 16-row slabs, K to its
    32-digit K-steps), then into S = Rp / 16 row slabs and KS = Kp / 32
    K-steps. Each tile (s, ks) is [nb, 32, 4]: entry [b, lane] holds the
    four registers of lane's m16n8k32 A fragment of block b's tile: with
    g = lane / 4 and t = lane % 4, register j holds the four digits of row
    16 s + g + 8 (j % 2) at columns 32 ks + 4 t + 16 (j / 2), the lowest
    column in the lowest byte. A warp reads one tile of one block as 512
    contiguous bytes, 16 a lane. The tiles come round by round, `per`
    slabs a round and the last round the slabs left, each round K-step by
    K-step: so a run of K-steps of one round, or a run of its slabs at one
    K-step, is one run of bytes (a stage of the ladder's ring). With
    per = 1 the tiles lie slab by slab, as the limb kernels read them.
    """
    rows, K = w.shape[0] // nb, w.shape[1]
    S, KS = -(-rows // 16), -(-K // 32)
    blocks = torch.zeros((nb, 16 * S, 32 * KS), dtype=torch.int8,
                         device=w.device)
    blocks[:, :rows, :K] = w.reshape(nb, rows, K)
    # [b, s, h, g, ks, jh, t, byte] -> [s, ks, b, g, t, jh, h, byte]
    tiles = blocks.reshape(nb, S, 2, 8, KS, 2, 4, 4)
    tiles = tiles.permute(1, 4, 0, 3, 6, 5, 2, 7).reshape(S * KS, nb * 512)
    if per > 1:
        tiles = tiles[_stage_order(S, KS, per).to(w.device)]
    return tiles.contiguous().view(torch.int32).reshape(S * KS, nb, 32, 4)


def unpack_blocks(packed, K, per=1):
    """The inverse of pack_blocks for a matrix of K columns: int8
    [nb Rp, Kp], padding kept."""
    T, nb = packed.shape[:2]
    KS = -(-K // 32)
    S = T // KS
    tiles = packed
    if per > 1:
        tiles = torch.empty_like(packed)
        tiles[_stage_order(S, KS, per).to(packed.device)] = packed
    tiles = tiles.reshape(S, KS, nb, 8, 4, 2, 2, 1).view(torch.int8)
    return tiles.permute(2, 0, 6, 3, 1, 5, 4, 7).reshape(nb * 16 * S, 32 * KS)


def _table(B, elems, window, cpad, dev):
    """The kernel's table scratch: 2^window rows of cpad words for each
    element its blocks hold, ceil(B / elems) blocks rounded up to whole
    clusters (the last cluster's spare block computes on zeros)."""
    blocks = -(-B // elems)
    return torch.empty((-(-blocks // CLUSTER) * CLUSTER * elems, 1 << window,
                        cpad), dtype=torch.int32, device=dev)


def _columns(sys_):
    """(w_ext1, w_ext2) packed for the kernel, once per system: rounds of
    one slab for each of the block's warps."""
    cols = _packed.get(sys_.w_ext1)
    if cols is None:
        per = _warps(sys_.k)
        cols = _packed[sys_.w_ext1] = (pack_blocks(sys_.w_ext1, 3, per),
                                       pack_blocks(sys_.w_ext2, 3, per))
    return cols


def _digits_on(digits, window, dev):
    """The digit schedule as contiguous int64 [n_windows] on dev.

    A schedule from the host is range-checked before its upload. One
    already on the card was built by mg.exponent_digits at this window, so
    its digits lie in [0, 2^window): checking them would sync with the
    host at every launch. The kernel masks each digit to the window.
    """
    if not (isinstance(digits, torch.Tensor) and digits.device == dev):
        host = torch.as_tensor(digits, dtype=torch.int64, device="cpu")
        if not bool(((host >= 0) & (host < (1 << window))).all()):
            raise ValueError("digits must lie in [0, 2^window)")
        digits = config.to_device(host, dev)
    if digits.dtype != torch.int64 or digits.dim() != 1:
        raise ValueError("digits must be 1-D int64, got %s %s"
                         % (digits.dtype, tuple(digits.shape)))
    return digits.contiguous()


def _digit_rows_on(digits, window, rows, dev):
    """Per-element schedules as contiguous int8 [rows, n_windows] on dev.

    Schedules from the host are range-checked before their upload, which
    does not wait for the copy; one already on dev (the wire form of
    batch._digits_rows, uploaded before a batch program) is taken as it
    is, and the kernel masks each digit to the window. The batch programs
    take their schedules through here before the call, so that nothing
    inside them copies from the host.
    """
    if not (isinstance(digits, torch.Tensor) and digits.device == dev):
        host = torch.as_tensor(digits, device="cpu")
        if not bool(((host >= 0) & (host < (1 << window))).all()):
            raise ValueError("digits must lie in [0, 2^window)")
        digits = config.to_device(host.to(torch.int8), dev)
    if digits.dtype != torch.int8 or digits.dim() != 2 or (
            digits.shape[0] != rows):
        raise ValueError("digits must be int8 [%d, n_windows], got %s %s"
                         % (rows, digits.dtype, tuple(digits.shape)))
    return digits.contiguous()


def _row(t, name, C, dev):
    if t.device != dev or t.dtype != torch.int64 or tuple(t.shape) != (C,):
        raise ValueError("%s must be int64 [%d] on %s, got %s %s on %s"
                         % (name, C, dev, t.dtype, tuple(t.shape), t.device))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
    return t.data_ptr()


def _launch(x_res, digits, sys_, window, exit_res, entry_res, vec, elems):
    """One launch of the kernel's instantiation for `elems` elements a
    block, in clusters of CLUSTER blocks. The wrappers take elems from
    _elems; chip_smoke.py's one-product split compares instantiations on
    the same rows."""
    dev = x_res.device
    C, k = sys_.cpad, sys_.k
    if x_res.dim() != 2 or x_res.shape[1] != C:
        raise ValueError(
            "x_res must be [B, %d], got shape %s" % (C, tuple(x_res.shape))
        )
    if x_res.dtype != torch.int64 or not x_res.is_contiguous():
        raise TypeError("x_res must be contiguous int64")
    if not 1 <= window <= 8:
        raise ValueError("window must be in [1, 8], got %d" % window)
    if vec:
        digits = _digit_rows_on(digits, window, x_res.shape[0], dev)
    else:
        digits = _digits_on(digits, window, dev)
    entry = sys_.r2_dom if entry_res is None else entry_res
    exitc = sys_.scale if exit_res is None else exit_res
    rows = [_row(getattr(sys_, f), "sys_." + f, C, dev) for f in _ROWS]
    rows += [_row(entry, "entry_res", C, dev), _row(exitc, "exit_res", C, dev),
             _row(sys_.mbinv_r, "sys_.mbinv_r", 1, dev)]
    for name in ("w_ext1", "w_ext2"):
        if getattr(sys_, name).device != dev:
            raise ValueError("sys_.%s is not on %s" % (name, dev))
    B = x_res.shape[0]
    out = torch.empty_like(x_res)
    if B == 0:
        return out
    if _smem(k, elems) > SMEM_LIMIT:
        raise ValueError("an RNS ladder block of %d elements at k = %d needs "
                         "%d bytes of shared memory, over %d"
                         % (elems, k, _smem(k, elems), SMEM_LIMIT))
    w1p, w2p = _columns(sys_)
    fn = _lib(vec, elems)
    table = _table(B, elems, window, C, dev)
    rc = fn(
        x_res.data_ptr(), out.data_ptr(), table.data_ptr(), B, k, C,
        *rows, w1p.data_ptr(), w2p.data_ptr(),
        digits.data_ptr(), digits.shape[-1], window,
        _build.stream_handle(dev),
    )
    name = "rns_ladder_vec" if vec else "rns_ladder"
    if rc != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (name, rc))
    launches[name] += 1
    return out


def ladder(x_res, digits, sys_, window=rns.DEFAULT_WINDOW, exit_res=None,
           entry_res=None):
    """Windowed RNS modexp over [B, cpad] stored residues, shared exponent.

    Returns [B, cpad] residues of (x F)^e E mod N, value <= kN + 1 (see
    rns.ladder_plain for the entry constant F and exit constant E).
    """
    if x_res.device.type == "cuda":
        return _launch(x_res, digits, sys_, window, exit_res, entry_res,
                       False, _elems(sys_.k, x_res.shape[0],
                                     _sms(x_res.device)))
    if x_res.device.type == "cpu":
        return rns.ladder_plain(x_res, digits, sys_, window=window,
                                exit_res=exit_res, entry_res=entry_res)
    raise ValueError("no RNS ladder for device %s" % x_res.device)


def ladder_vec(x_res, digits, sys_, window=rns.DEFAULT_WINDOW, exit_res=None,
               entry_res=None):
    """Windowed RNS modexp over [B, cpad] stored residues, per-element
    exponents: digits [B, n_windows], int8 on the card or any integer type
    on the host. Returns [B, cpad] residues of (x F)^e_i E mod N, value
    <= kN + 1 (see rns.ladder_vec_plain).
    """
    if x_res.device.type == "cuda":
        return _launch(x_res, digits, sys_, window, exit_res, entry_res,
                       True, _elems(sys_.k, x_res.shape[0],
                                     _sms(x_res.device)))
    if x_res.device.type == "cpu":
        return rns.ladder_vec_plain(x_res, digits, sys_, window=window,
                                    exit_res=exit_res, entry_res=entry_res)
    raise ValueError("no RNS ladder for device %s" % x_res.device)
