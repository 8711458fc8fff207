"""Drive phe_tpu_torch's main path on one NVIDIA GPU and check every kernel.

Run from the repository root:  python3 chip_smoke.py [--parent DIR]

(DIR: the root of another checkout, such as the parent commit unpacked
with git archive, whose RNS ladder phase 2 times against this one's.)

Phases, each fatal on failure (non-zero exit, no result line):

1. Build every CUDA kernel from the checkout's sources (one nvcc per
   source, started together); print the build seconds, the compiler's
   per-kernel register and spill report (the ladder's four
   instantiations by name), and the card's name and power limit. Read the SASS (cuobjdump) of the ladder, the limb-engine modexp
   and the Montgomery product: every instantiation of each runs its digit
   products (the ladder's base extensions, the two REDC products of the
   modexp and the product) on the int8 tensor cores (IMMA) and none on
   __dp4a (IDP4A); the limb kernels' integer-pipe instantiations (E = 8,
   32 and the one-row cluster tile, E = 1) run neither.
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes: 16,384 rows at the fixed 2048-bit key. The
   Montgomery product runs at L = 296 (n^2), 152 (p^2) and 80 (p), and at
   L = 440 (the 3072-bit key's n^2), and is checked value mod M against
   the plain version and Python ints, with the limb and value bounds; each
   check prints E and the rows a block held and fails a time under its
   bound. The RNS ladder runs at k = 304 (exponent n, exit
   R) and k = 152 (exponent p-1, exit R^(1-p)); its first 128 rows are
   checked bit-equal against the plain version, which is too slow for the
   whole batch, and four rows against Python pow; at k = 456 (the
   3072-bit key's n^2, exponent n) over 16,384 rows, 32 of them against
   the plain version; and at k = 624 (the 8192-bit key's p^2, exponent
   p-1) over 512 rows, 8 of them against the plain version. Each prints
   the elements a block held (E) and fails if it ran under its bound.
   Ragged batches of both ladder modes are bit-equal: at E = 8 (1, 7 and
   9 rows) on every row, and at E = 32 (a last block of 1 and of 31
   elements) on their first rows and last two blocks. One product's time
   at every E (k = 304 and 456 over 16,384 rows, k = 624 over 512; at
   k = 456 the whole r^n ladder at every E too; each with its clusters'
   width and the matrices' L2 bytes an element-product) and
   torch._int_mm over the extension GEMMs (a yardstick the port never
   calls) split the ladder's time. With --parent, the ladder of both
   checkouts at LADDER_TURNS' shapes, each in a process of its own, in
   turns parent, change, change, parent, beside ladder_bound, their
   residues equal. The tolerance is zero everywhere: this is exact integer
   arithmetic.
   The per-element-exponent kernels run at their path's shapes too: the
   RNS ladder at window 4 on 64-bit schedules, at k = 304 over 65,536
   rows and at k = 456 (the 3072-bit key's alignment) over 16,384 (each
   bit-equal to its plain version on the first 1,024 rows, seven rows
   against Python pow, its E printed, no faster than its bound); the
   limb-engine modexp at L = 296 over 16,384
   rows of 320-bit schedules (value-equal on 1,024 rows, six against
   Python pow, its E printed, no faster than its bound); its
   shared-exponent form with the exponent n on one row and on 128 rows;
   both forms on ragged batches at E = 8 (1, 7 and 9 rows) and E = 32 (a
   last block of 1 and of 31 rows), against their plain versions and
   Python pow. The shared-table matvec's select kernel
   (check_table_select) is bit-equal to its plain version at
   vfl_credit-2048's grids (30,000 bases, 13 and 11 rows, 24 windows,
   both signs, and 13 rows with one sign) and a ragged one (5 x 257 x
   33), one launch a chunk of bases as batch._matvec takes them,
   and no faster than its bound.
3. The main path at 16,384 ciphertexts: EncryptedBatch.encrypt of seeded
   uniform floats in +-1e6, then decrypt, with every kernel's launch count
   read around it; a pinned-r batch against the host's raw_encrypt; one
   secure export round trip; encrypt and decrypt ops/s. Then the same
   round trip and pinned-r check at the 3072-bit default key size
   (default_key_path: n^2 on the ladder at k = 456 in blocks of E = 32,
   the products at L = 440 in blocks of E = 8), its key constants and
   REDC matrices timed apart.
4. The arithmetic path, each step with the counts zeroed just before it
   and read just after, checked exactly against the host and timed on the
   host clock: add at equal exponents over 524,288 rows (and once more
   under profiling.trace) and aligned over
   65,536, add_scalars aligned, mul_scalars with mixed-sign floats over
   65,536 rows, sum and dot at mixed exponents, encrypted
   logistic-regression scoring of 1,024 examples x 21 weights (the shared
   table's launches pinned), federated aggregation of 5 x 16,384
   gradients, and short-obfuscated encryption. Then the matvec program
   against per-element modexps and a tree, the parent's algorithm
   (matvec_small_grids), at MATVEC_SHAPES' small grids of the 2048-,
   3072- and 8192-bit keys: their ciphertexts equal, each timed in turns.
   Phase 2 also holds the issue-rate chain (phe_tpu_torch.microbench's
   kernel) bit-equal to its plain version for all five bodies on the full
   [256, 512] tile at K = 4,000, no faster than its bound (CHAIN_ISSUE),
   and the Montgomery product at L = 1,176
   (the 8192-bit key's n^2) on 1,024 rows.
5. The calibration: phe_tpu_torch.microbench.main() (five bodies, K =
   4,000 and 32,000, the fold guard), its two rates printed beside the
   published int32 rate of the bounds here and the H100 row of
   phe_tpu_torch.profiling.
6. The benchmarks: phe_tpu_torch.bench.main() at bench.py's sizes (2,048
   bits; BENCH_RUNS timed and BENCH_WARMUP untimed streamed passes per op),
   phe_tpu_torch.benchmarks.main(["--key-sizes", "1024,2048", "--mem"]),
   and one 16,384-row encrypt and decrypt under profiling.trace, with the
   profiler's top ten kernels by device time and the card's busy share.
7. The limb engine at the fixed 8192-bit key, whose n^2 is past the RNS
   channel supply (see limb_engine_path), with one of its decrypts under
   profiling.trace, and its modexp kernel timed at the encrypt's own
   launch (r^n over 512 rows at L = 1,176) and on 2 rows. Then the
   two-body sweep (body_sweep): both products and both modexps at every
   (L, B) of SWEEP_KEYS' moduli and SWEEP_ROWS (SWEEP_POW_ROWS for the
   modexps), and the 8192-bit r^n, each in both REDC bodies in turns
   (int8, int, int, int8) beside the body cuda_modexp._body picks, the
   two bodies' outputs equal mod M; it fails where the rule's body ran
   a modexp more than 5 % slower than the other in both turns.
8. Wire formats, CLI, CRT powers, mesh (wire_path), at the fixed 2048-bit
   key over 16,384 rows, each step timed with its launches: encrypt,
   dump_encrypted_batch (secure), json.dumps, json.loads,
   load_encrypted_batch onto the card and decrypt, equal to x on every
   row, and the dump's pin, secure export and decimal strings apart; a
   pinned-r batch of 8 whose dump equals the host's raw_encrypt, JSON for
   JSON; pheutil's six vector commands in this process on JWK files of
   the key (each result the exactly rounded one) and encryptvec /
   decryptvec in a process of their own; the key constants a command
   pays; PrivateDeviceContext.crt_powers over 16,384 rows (Python's pow on
   64 sampled rows), and its mont_pow_shared at L = 152 against its plain
   version on 64 rows and its bound; the native host engine built
   (HAVE_NATIVE) and its powmod equal to pow at 2048 bits; a world of one
   on NCCL whose encrypted_sum_sharded equals batch.sum() and whose FL
   aggregation with the mesh equals it without.
9. The batch programs (phe_tpu_torch.programs: each captured once per
   shape and key as a CUDA graph, replayed in one call; phases 3-8 run
   through them): every program those phases reach, bit-equal to its
   eager body at the 2048-bit key over 16,384 rows (the add's product
   over 524,288), the 3072-bit key over 16,384 and the 8192-bit key over
   512, with its eager, first-call and replay times on the host clock,
   its launches a call (equal to the body's) and its graphs; a 2048-bit
   round trip from the upload to decrypt's device half under
   torch.cuda.set_sync_debug_mode("error"); a second encrypt leaving the
   first batch's limbs unchanged; the 2048-bit round trip and the
   8192-bit decrypt under profiling.trace, eagerly (the bodies) and
   through the programs in turns, each with its CUDA runtime calls; the
   memory the card holds after it.

The second-to-last lines are the kernels' JSON record, the seconds the
whole run took, and the card's name and power limit; the last line is
the device record. Kernel times are
CUDA-event times; bounds use NVIDIA's published H100 SXM peaks, and for
the issue-rate chain the instructions its SASS issues (CHAIN_ISSUE).
"""

import json
import os
import random
import re
import sys
import time

import numpy as np
import torch

BATCH = 16384  # encrypt and decrypt batch (the repo's headline workload)
ADD_ROWS = 524288  # bench.py's add batch
MUL_ROWS = 65536  # bench.py's mul batch
SEED = 20261016
PLAIN_CHUNK = 2048  # rows per plain Montgomery product at L = 296 (its
# memory grows with rows x L^2: wider contexts take proportionally fewer)
PLAIN_LADDER_ROWS = 128  # rows of the plain ladder check (>= 64)
PLAIN_LADDER_ROWS_456 = 32  # rows of the plain ladder check at k = 456
PLAIN_LADDER_ROWS_624 = 8  # rows of the plain ladder check at k = 624
PLAIN_VEC_ROWS = 1024  # rows of the plain per-element modexp checks
SHARED_POW_ROWS = 128  # rows of the shared-exponent modexp's second check
SHORT_BITS = 320  # short obfuscation's exponent bits
LR_EXAMPLES, LR_FEATURES = 1024, 20
FL_CLIENTS = 5  # phe_tpu/models/federated.py's default
CHAIN_K = 4000  # the issue-rate chain's K in the kernel check
WIDE_ROWS = 1024  # rows of the Montgomery-product checks at L = 1,176
BENCH_RUNS, BENCH_WARMUP = 3, 1  # bench.main's streamed passes (of 5, 2)
LIMB_ROWS = 512  # the 8192-bit batch (BENCH_8192.json's)
LIMB_DIRECT_ROWS = 64  # rows through _decrypt_residue_limb
LIMB_POW_ROWS = 16  # rows of mont_pow against its plain version at L = 1,176
WIRE_FEW = 8  # the pinned-r batch whose dump is held against raw_encrypt
CRT_SAMPLE = 64  # crt_powers rows held against Python's pow
CRT_PLAIN_ROWS = 64  # rows of mont_pow_shared's plain version at L = 152
CLI_FEW = 4  # values of the CLI run in a process of its own
CLI_TIMEOUT_S = 300
# The two-body sweep (body_sweep): the moduli of the fixed 2048-, 3072- and
# 8192-bit keys (n^2, p^2, p: L = 296, 152, 80; 440, 224, 112; 1,176,
# 592, 296), the products at every batch a FedAvg step launches there
# (a client call of 16,384, 4,096, 512 or 64 rows and the product tree's
# 5-, 2- and 1-call widths over 10 clients) and past them, and both
# modexp forms on SWEEP_BITS-bit exponents at the calls' widths.
SWEEP_KEYS = (2048, 3072, 8192)
SWEEP_ROWS = (64, 128, 320, 512, 1024, 2560, 4096, 8192, 16384, 20480,
              32768, 81920)
SWEEP_POW_ROWS = (64, 512, 4096, 16384)
SWEEP_BITS = 64
SWEEP_MS = 30.0  # the least CUDA-event milliseconds of one timed turn
# NVIDIA H100 SXM published peaks (data sheet; Hopper white paper).
HBM_BYTES_PER_S = 3.35e12
INT8_MAC_PER_S = 1979e12 / 2  # 1,979 TOP/s int8 dense, 2 ops per MAC
# 64 INT32 lanes per SM x 132 SMs x 1.98 GHz (the clock behind the 67
# TFLOP/s fp32 peak): integer multiply-adds, shifts, compares per second.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# The issue-rate chain's instructions an iteration on sm_90a, as
# cuobjdump -sass shows its unrolled loops: (integer ALU pipe: IADD3, SHF,
# ISETP, SEL; FMA pipe: IMAD and its MOV and IADD forms). ptxas merges
# add's iterations in pairs (one IADD3 of a + x + x) and shiftmul's
# neighbouring shifts (one SHF by 28); barrett balances its eight over the
# two pipes. Each pipe retires 64 lanes a clock an SM, INT32_OPS_PER_S.
CHAIN_ISSUE = {"mul": (0, 1), "add": (0.5, 0), "muladd": (0, 1),
               "shiftmul": (1, 1), "barrett": (4, 4)}
# The select kernel's grids (B rows, D bases, W windows, signs):
# vfl_credit-2048's two (13 and 11 features against 30,000 residuals at 24
# windows), the first with one sign, and a ragged one.
SELECT_SHAPES = ((13, 30000, 24, 2), (11, 30000, 24, 2), (13, 30000, 24, 1),
                 (5, 257, 33, 2))
# The small matvec grids (B, D) by key size: one element; one example
# scored against 21 weights and more examples (models/logreg.py); a
# feature's rows of X^T [[d]] (models/hetero_lr.py) at a few batch sizes;
# on the RNS route (2048 and 3072 bits) and the limb route (8192 bits).
MATVEC_SHAPES = {
    2048: ((1, 1), (1, 21), (16, 21), (13, 128), (13, 1024)),
    3072: ((1, 21), (13, 128)),
    8192: ((1, 21), (4, 21), (13, 32)),
}
MATVEC_MS = 30.0  # the least CUDA-event milliseconds of one timed turn


def fail(msg):
    print("FAILED: " + msg, file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def redc_seconds(contexts):
    """Seconds to build and pack the REDC matrices of a key's Montgomery
    contexts (n^2, p^2, q^2, p, q), which both limb kernels read: what the
    key's first product launches would pay for them otherwise."""
    from phe_tpu_torch.ops import cuda_modexp

    sync()
    t0 = time.perf_counter()
    for ctx in contexts:
        cuda_modexp._pow_columns(ctx)
    sync()
    return time.perf_counter() - t0


def key_contexts(dc, pdc):
    c = pdc.consts
    return (dc.ctx, c.ctx_p, c.ctx_q, c.ctx_hp, c.ctx_hq)


def cuda_ms(fn, reps, warm=True):
    """Mean CUDA-event milliseconds of fn over reps runs."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_once(fn):
    """(fn(), its CUDA-event milliseconds) for one call of a long kernel."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound_ms(nbytes, int8_macs=0, int32_ops=0):
    """(least milliseconds the card could take, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(int8_macs / INT8_MAC_PER_S, int32_ops / INT32_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def mont_mul_bound(rows, L, shared):
    """Montgomery product at its cheapest, as the TPU kernel computes it:
    REDC as two int8 digit matmuls against key constants (q = T_lo M'
    against [2L, 2L], q M against [4L, 2L]: 12 L^2 int8 multiply-adds per
    row); a*b as L^2 int32 multiply-adds, or, with b shared, as one more
    digit matmul against a [4L, 2L] matrix of b (8 L^2 int8). Bytes: the
    int64 operand rows read and the output written; the digit matrices
    (one int8 byte per multiply-add of a row) read once."""
    per_row = (20 if shared else 12) * L * L
    nbytes = 8 * rows * L * (2 if shared else 3) + per_row
    return bound_ms(nbytes, int8_macs=rows * per_row,
                    int32_ops=0 if shared else rows * L * L)


def ladder_bound(rows, k, n_windows, window, vec=False):
    """RNS ladder: per Montgomery product and element, two base extensions
    of 3(k+8) x 2k int8 multiply-adds, and the channel arithmetic: about
    cpad + 31k + 65(k+8) int32 operations (channel product; sigma with its
    Barrett reduction and digits; q^ and u~ with two digit recombinations
    and three Barrett reductions; S, the beta fold and its reduction).
    Bytes: the int64 residue rows in and out, the constant rows, the
    digits (int64 [n_windows], or int8 [rows, n_windows] with vec) and
    both extension matrices, each read once."""
    cpad, K1 = 2 * k + 8, k + 8
    products = 2 + (2**window - 2) + n_windows * (window + 1)
    int8 = rows * products * 2 * (3 * K1) * (2 * k)
    int32 = rows * products * (cpad + 31 * k + 65 * K1)
    digit_bytes = rows * n_windows if vec else 8 * n_windows
    nbytes = (8 * (2 * rows * cpad + 12 * cpad) + digit_bytes
              + 2 * 3 * K1 * 2 * k)
    return bound_ms(nbytes, int8_macs=int8, int32_ops=int32)


def pow_products(window, n_windows):
    """(squarings, multiplies) a row of the windowed modexp runs: the
    table's 2^w - 2 products, then w squarings and one product a window."""
    return window * n_windows, (2**window - 2) + n_windows


def mont_pow_bound(rows, L, window, n_windows, digit_bytes):
    """Windowed limb-engine modexp, per row pow_products(window,
    n_windows): each product's REDC as 12 L^2 int8 multiply-adds (the two
    digit matmuls), its a*b as L^2 int32 multiply-adds, or L (L + 1) / 2
    for a squaring (each cross term once). Bytes: the int64 base rows in
    and out, R mod M, the digits and the REDC digit matrices, each read
    once."""
    sq, mul = pow_products(window, n_windows)
    nbytes = 8 * (2 * rows * L + L) + digit_bytes + 12 * L * L
    return bound_ms(nbytes, int8_macs=rows * (sq + mul) * 12 * L * L,
                    int32_ops=rows * (sq * L * (L + 1) // 2 + mul * L * L))


def body_pow_bound(mxu, rows, L, window, n_windows, digit_bytes):
    """A modexp launch's bound in its REDC body: mont_pow_bound for the
    int8 one (mxu), else int_pipe_bound over its squarings and products."""
    if mxu:
        return mont_pow_bound(rows, L, window, n_windows, digit_bytes)
    sq, mul = pow_products(window, n_windows)
    return int_pipe_bound(8 * (2 * rows * L + 3 * L) + digit_bytes, L, rows,
                          sq, mul)


def limbs_on(values, L, dev):
    from phe_tpu_torch.ops import montgomery as mg
    from phe_tpu_torch.utils import limbs as hl

    return mg._tensor(hl.ints_to_limbs(values, L), dev)


def int_pipe_bound(nbytes, L, rows, squarings=0, products=1):
    """The integer-pipe REDC body's least time over rows, each running
    `squarings` squarings and `products` general products at L, counted
    as the function needs them: a b as L^2 int32 multiply-adds (L (L + 1)
    / 2 for a squaring, each cross term once), q = T_lo M' mod R as its
    low half's L (L + 1) / 2, and q M as L^2; nbytes over the memory rate.
    (profiling.mont_mul_cost(L, mxu=False) counts 3 L^2 a product, more
    than this work.)"""
    half = L * (L + 1) // 2
    macs = squarings * (2 * half + L * L) + products * (2 * L * L + half)
    return bound_ms(nbytes, int32_ops=rows * macs)


def check_mont_mul(ctx, M, shared, rng, rows=BATCH):
    """The Montgomery product's kernel for ctx (the REDC body
    launch_body picks at its shape) against its plain version and Python
    ints over rows at L, value mod M with the contract's bounds, timed
    beside its bound; its record."""
    from phe_tpu_torch.ops import cuda_modexp
    from phe_tpu_torch.ops import montgomery as mg
    from phe_tpu_torch.utils import limbs as hl

    dev = ctx.m.device
    L = ctx.num_limbs
    mxu = launch_body(L, rows)
    R_inv = pow(1 << (14 * L), -1, M)
    xs = [rng.randrange(0, 2 * M) for _ in range(rows)]
    ys = [rng.randrange(0, 2 * M) for _ in range(1 if shared else rows)]
    a = limbs_on(xs, L, dev)
    b = limbs_on(ys, L, dev)[0] if shared else limbs_on(ys, L, dev)
    fn = cuda_modexp.mont_mul_const if shared else cuda_modexp.mont_mul
    chunk = max(1, PLAIN_CHUNK * 296 * 296 // (L * L))

    def plain():
        return torch.cat([
            cuda_modexp.mont_mul_plain(
                a[i : i + chunk], b if shared else b[i : i + chunk], ctx)
            for i in range(0, rows, chunk)])

    got = fn(a, b, ctx)
    ref = plain()
    sync()
    name = ("mont_mul_const" if shared else "mont_mul") + (
        "" if mxu else "_int")
    g = hl.limbs_to_ints(got.cpu().numpy())
    want = [x * (ys[0] if shared else y) * R_inv % M
            for x, y in zip(xs, ys * rows if shared else ys)]
    check([v % M for v in g] == want, "%s L=%d: kernel value mod M "
          "differs from Python ints" % (name, L))
    check(int(got.min()) >= 0 and int(got.max()) <= 1 << 14,
          "%s L=%d: limbs outside [0, 2^14]" % (name, L))
    check(all(100 * v < 101 * M for v in g),
          "%s L=%d: value not below 1.01 M" % (name, L))
    # Both outputs are < 1.01 M: their canonical forms are the values
    # mod M, compared limb for limb on the card.
    diff = (mg.export_canonical(got, ctx)
            - mg.export_canonical(ref, ctx)).abs().max()
    err = int(diff)
    check(err == 0, "%s L=%d: kernel value mod M differs from the "
          "plain version" % (name, L))
    ms = cuda_ms(lambda: fn(a, b, ctx), 10)
    plain_ms = cuda_ms(plain, 1)
    if mxu:
        bms, by = mont_mul_bound(rows, L, shared)
    else:
        bms, by = int_pipe_bound(8 * L * (rows * (2 if shared else 3) + 2),
                                 L, rows)
    tile = tile_text(L, rows, mxu, "mont_mul")
    print("%s L=%d rows=%d (%s; %d launches so far): value-equal, bounds "
          "hold; kernel %.4f ms, plain %.4f ms, bound %.4f ms (%s)"
          % (name, L, rows, tile, cuda_modexp.launches[name], ms, plain_ms,
             bms, by))
    check(ms >= bms, "%s L=%d ran under its bound: its count no longer "
          "matches the kernel" % (name, L))
    return dict(L=L, rows=rows, body=name, tile=tile, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, plain_rows=rows, bound_ms=bms,
                bound_by=by)


def sync():
    torch.cuda.synchronize()


def ladder_elems(k, rows):
    """The elements a ladder block holds for rows at k on this card, as
    the wrappers choose them."""
    from phe_tpu_torch.ops import cuda_rns

    return cuda_rns._elems(k, rows, cuda_rns._sms(torch.device("cuda")))


def launch_body(L, rows):
    """The REDC body of a limb-kernel launch of rows at L on this card
    (cuda_modexp._body): True for int8."""
    from phe_tpu_torch.ops import cuda_modexp, cuda_rns

    return cuda_modexp._body(L, rows, cuda_rns._sms(torch.device("cuda")))


def pow_tile(L, rows, mxu=True, kernel="mont_pow"):
    """(E, rows a block, blocks a cluster) of a limb-kernel launch of rows
    at L on this card, as the wrappers choose them for the REDC body (the
    integer pipe's clusters as many as the card holds at once)."""
    from phe_tpu_torch.ops import cuda_modexp

    return cuda_modexp._tile(L, rows, torch.device("cuda"), mxu, kernel)[:3]


def tile_text(L, rows, mxu=None, kernel="mont_pow"):
    """The launch's body (None: the one launch_body picks), tile, grid and
    cluster dims, as a phrase."""
    if mxu is None:
        mxu = launch_body(L, rows)
    E, per, C = pow_tile(L, rows, mxu, kernel)
    return "%s body, E = %d, %d rows a block, grid %d blocks in clusters " \
        "of %d" % ("int8" if mxu else "integer-pipe", E, per,
                   -(-rows // per) * C, C)


def _counters():
    from phe_tpu_torch.ops import cuda_microbench, cuda_modexp, cuda_rns

    return cuda_modexp.launches, cuda_rns.launches, cuda_microbench.launches


def reset_launches():
    for counts in _counters():
        for key in counts:
            counts[key] = 0


def read_launches():
    """The non-zero launch counts of every kernel wrapper."""
    return {k: v for counts in _counters() for k, v in counts.items() if v}


def run_step(fn, totals):
    """One main-path step: counts zeroed just before it, read just after.

    Returns (result, host seconds, launch counts) and adds the counts to
    totals. fn's device work ends in a synchronise before the clock stops.
    """
    reset_launches()
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    seconds = time.perf_counter() - t0
    counts = read_launches()
    for key, v in counts.items():
        totals[key] = totals.get(key, 0) + v
    return out, seconds, counts


def by_form(counts):
    """Launch counts by form: a limb kernel's launches in either REDC body
    (the integer pipe's counted under <form>_int) under the form's name."""
    out = {}
    for k, v in counts.items():
        form = k[:-4] if k.endswith("_int") else k
        out[form] = out.get(form, 0) + v
    return out


def expect_launches(step, counts, want):
    """counts == want, by form (by_form): each launch takes the body
    cuda_modexp._body picks at its shape."""
    counts = by_form(counts)
    check(counts == want, "%s launched %s, expected %s"
          % (step, json.dumps(counts), json.dumps(want)))


def tree_depth(rows):
    """Montgomery-product launches of a tree fold over rows (batch._tree_fold)."""
    return (rows - 1).bit_length()


def inverse_launches(rows, chunk):
    """(mont_mul, mont_mul_const) launches of EncryptedBatch.inverse_mont
    over rows bucketed rows: per chunk, the log-depth scan's levels and the
    exclusive product, then the total's export, its inverse's packing and
    the finishing product."""
    mm = mc = 0
    for lo in range(0, rows, chunk):
        mm += tree_depth(min(chunk, rows - lo)) + 1
        mc += 3
    return mm, mc


def host_timed(fn):
    """(fn's result, its ms on the host clock, the card synchronised)."""
    sync()
    t0 = time.perf_counter()
    res = fn()
    sync()
    return res, 1e3 * (time.perf_counter() - t0)


def check_ladder_vec(pub, dev, rng, rows):
    """Phase 2, the per-element RNS ladder at n^2 of pub's key over rows
    of 64-bit schedules at window 4 (mul_scalars' shape, and an
    alignment's) on Montgomery-domain operands, entry M_A^2 R^-1, exit R:
    bit-equal to its plain version on the first PLAIN_VEC_ROWS rows,
    seven rows against Python pow, no faster than its bound; its record."""
    from phe_tpu_torch import batch as tbatch
    from phe_tpu_torch.ops import cuda_rns
    from phe_tpu_torch.ops import montgomery as mg
    from phe_tpu_torch.ops import rns
    from phe_tpu_torch.utils import limbs as hl

    dc = pub.device_context(dev)
    st, L, N = dc.rns_state(), dc.L, pub.nsquare
    k = st.rsys.k
    R = 1 << (14 * L)
    R_inv = pow(R, -1, N)
    few = PLAIN_VEC_ROWS
    xs = [rng.randrange(0, N) for _ in range(rows)]
    es = [rng.getrandbits(64) for _ in range(rows - 3)] + [0, 1, (1 << 64) - 1]
    digits = torch.as_tensor(tbatch._digits_rows(es, 64), device=dev)
    n_windows = digits.shape[1]
    x_res = rns.to_rns(mg._tensor(hl.ints_to_limbs(xs, L), dev), st.conv,
                       st.rsys).contiguous()
    run = lambda x, d: cuda_rns.ladder_vec(x, d, st.rsys,
                                           entry_res=st.entry_mont,
                                           exit_res=st.exit_r)
    got = run(x_res, digits)
    head, dhead = x_res[:few].contiguous(), digits[:few].contiguous()
    ref, plain_ms = host_timed(lambda: rns.ladder_vec_plain(
        head, dhead, st.rsys, entry_res=st.entry_mont, exit_res=st.exit_r))
    check(torch.equal(got[:few], ref), "rns_ladder_vec k=%d: kernel residues "
          "differ from the plain version" % k)
    tail = list(range(4)) + [rows - 3, rows - 2, rows - 1]
    vals = hl.limbs_to_ints(rns.from_rns(got[tail], st.rsys).cpu().numpy())
    for i, v in zip(tail, vals):
        check(v % N == pow(xs[i] * R_inv, es[i], N) * R % N,
              "rns_ladder_vec k=%d: value differs from Python pow" % k)
    ms = cuda_ms(lambda: run(x_res, digits), 1, warm=False)
    ms_few = cuda_ms(lambda: run(head, dhead), 1)
    bms, by = ladder_bound(rows, k, n_windows, 4, vec=True)
    select_ms = 1e3 * (rows * n_windows * 16 * st.rsys.cpad * 4
                       / HBM_BYTES_PER_S)
    elems = ladder_elems(k, rows)
    print("rns_ladder_vec k=%d windows=%d: bit-equal on %d rows, Python pow "
          "on %d; kernel %.3f ms at %d rows, E = %d (%.3f ms at %d, E = %d), "
          "plain %.3f ms at %d, bound %.3f ms at %d (%s); the table select's "
          "reads alone %.3f ms at HBM rate"
          % (k, n_windows, few, len(tail), ms, rows, elems, ms_few, few,
             ladder_elems(k, few), plain_ms, few, bms, rows, by, select_ms))
    check(ms >= bms, "rns_ladder_vec k=%d ran under its bound: "
          "ladder_bound's count no longer matches the kernel" % k)
    return dict(k=k, rows=rows, elems=elems,
                max_abs_err=int((got[:few] - ref).abs().max()),
                ms=ms, plain_ms=plain_ms, plain_rows=few,
                ms_at_plain_rows=ms_few, bound_ms=bms, bound_by=by)


def check_vec_kernels(pub, dev, rng):
    """Phase 2, the per-element-exponent kernels against their plain
    versions at the arithmetic path's shapes; {kernel name: record}."""
    from phe_tpu_torch import batch as tbatch
    from phe_tpu_torch.ops import cuda_modexp
    from phe_tpu_torch.ops import montgomery as mg
    from phe_tpu_torch.utils import limbs as hl

    dc = pub.device_context(dev)
    ctx, L, N = dc.ctx, dc.L, pub.nsquare
    R = 1 << (14 * L)
    R_inv = pow(R, -1, N)
    few = PLAIN_VEC_ROWS
    out = {}

    def canonical_err(got, ref):
        """max |canonical(got) - canonical(ref)| over the limbs, on the card:
        both are < 1.01 M, so their canonical forms are the values mod M."""
        return int((mg.export_canonical(got, ctx)
                    - mg.export_canonical(ref, ctx)).abs().max())

    out["rns_ladder_vec"] = check_ladder_vec(pub, dev, rng, MUL_ROWS)

    # mont_pow: short obfuscation's h^a, 320-bit exponents, window 4.
    rows = BATCH
    xs = [rng.randrange(0, 2 * N) for _ in range(rows)]
    es = ([rng.getrandbits(SHORT_BITS) for _ in range(rows - 2)]
          + [0, (1 << SHORT_BITS) - 1])
    base = mg._tensor(hl.ints_to_limbs(xs, L), dev)
    digits = torch.as_tensor(tbatch._digits_rows(es, SHORT_BITS), device=dev)
    n_windows = digits.shape[1]
    got = cuda_modexp.mont_pow(base, digits, ctx)
    ref, plain_ms = host_timed(lambda: mg.mont_pow_plain(
        base[:few], digits[:few], ctx))
    err = canonical_err(got[:few], ref)
    check(err == 0, "mont_pow: kernel value mod M differs from the plain "
          "version")
    g = hl.limbs_to_ints(got.cpu().numpy())
    check(int(got.min()) >= 0 and int(got.max()) <= 1 << 14
          and all(100 * v < 101 * N for v in g),
          "mont_pow: limbs outside [0, 2^14] or value not below 1.01 M")
    for i in list(range(4)) + [rows - 2, rows - 1]:
        check(g[i] % N == pow(xs[i] * R_inv, es[i], N) * R % N,
              "mont_pow: value differs from Python pow")
    ms = cuda_ms(lambda: cuda_modexp.mont_pow(base, digits, ctx), 1,
                 warm=False)
    products = sum(pow_products(4, n_windows))
    bms, by = mont_pow_bound(rows, L, 4, n_windows, rows * n_windows)
    select_ms = 1e3 * rows * n_windows * 16 * L * 4 / HBM_BYTES_PER_S
    elems = tile_text(L, rows)
    print("mont_pow L=%d windows=%d: value-equal on %d rows, Python pow on "
          "6; kernel %.3f ms at %d rows, %s, plain %.3f ms at %d, bound "
          "%.3f ms (%s, %d products a row); the table select's reads alone "
          "%.3f ms at HBM rate"
          % (L, n_windows, few, ms, rows, elems, plain_ms, few, bms, by,
             products, select_ms))
    check(ms >= bms, "mont_pow ran under its bound: mont_pow_bound's count "
          "no longer matches the kernel")
    out["mont_pow"] = dict(L=L, rows=rows, tile=elems, max_abs_err=err,
                           ms=ms, plain_ms=plain_ms, plain_rows=few,
                           bound_ms=bms, bound_by=by, products=products)
    del base, got, ref

    # mont_pow_shared: h = x^n, one row per key (window 5), and 128 rows.
    rows = SHARED_POW_ROWS
    xs = [rng.randrange(0, 2 * N) for _ in range(rows)]
    base = mg._tensor(hl.ints_to_limbs(xs, L), dev)
    ndig = dc.n_digits
    run = lambda b: cuda_modexp.mont_pow_shared(b, ndig, ctx, window=5)
    got, one = run(base), run(base[:1].contiguous())
    ref1, plain_ms = host_timed(lambda: mg.mont_pow_shared_plain(
        base[:1], ndig, ctx, window=5))
    ref, plain_ms_rows = host_timed(lambda: mg.mont_pow_shared_plain(
        base, ndig, ctx, window=5))
    err = max(canonical_err(one, ref1), canonical_err(got, ref),
              canonical_err(got[:1], one))
    check(err == 0, "mont_pow_shared: kernel value mod M differs from the "
          "plain version")
    g = hl.limbs_to_ints(got.cpu().numpy())
    check(int(got.min()) >= 0 and int(got.max()) <= 1 << 14
          and all(100 * v < 101 * N for v in g),
          "mont_pow_shared: limbs outside [0, 2^14] or value not below 1.01 M")
    for i in range(4):
        check(g[i] % N == pow(xs[i] * R_inv, pub.n, N) * R % N,
              "mont_pow_shared: value differs from Python pow")
    ms = cuda_ms(lambda: run(base[:1].contiguous()), 3)
    ms_rows = cuda_ms(lambda: run(base), 1, warm=False)
    products = sum(pow_products(5, len(ndig)))
    bms, by = body_pow_bound(launch_body(L, 1), 1, L, 5, len(ndig),
                             8 * len(ndig))
    check(ms >= bms and ms_rows >= body_pow_bound(
              launch_body(L, rows), rows, L, 5, len(ndig), 8 * len(ndig))[0],
          "mont_pow_shared ran under its bound")
    print("mont_pow_shared L=%d windows=%d: value-equal on 1 and %d rows, "
          "Python pow on 4; kernel %.3f ms at 1 row, %s (%.3f ms at %d, "
          "%s), plain %.3f ms at 1 row (%.3f ms at %d), bound %.4f ms at "
          "1 row (%s, %d products)"
          % (L, len(ndig), rows, ms, tile_text(L, 1), ms_rows, rows,
             tile_text(L, rows), plain_ms, plain_ms_rows, rows, bms, by,
             products))
    out["mont_pow_shared"] = dict(
        L=L, rows=1, tile=tile_text(L, 1), max_abs_err=err, ms=ms,
        plain_ms=plain_ms, plain_rows=1, ms_at_128_rows=ms_rows,
        plain_ms_at_128_rows=plain_ms_rows, bound_ms=bms, bound_by=by,
        products=products)
    return out


def check_table_select(dev):
    """Phase 2, the shared-table matvec's select kernel
    (cuda_modexp.table_select) bit-equal to its plain version over each
    SELECT_SHAPES grid in the chunks of bases batch._matvec takes:
    vfl_credit-2048's two grids (30,000 bases, 13 and 11 rows, 24
    windows, both signs; 13 rows with one sign) and a ragged one, at L =
    296, on seeded limbs in [0, 2^14], digits and signs. Its time over the
    whole grid (one launch a chunk) beside its plain version's and its
    bound: the selections written and the tables, digits and signs read
    once. Returns the records, the first the widest grid."""
    from phe_tpu_torch import batch as tbatch
    from phe_tpu_torch.ops import cuda_modexp

    L = 296
    g = torch.Generator(device=dev)
    out = []
    for B, D, W, signs in SELECT_SHAPES:
        g.manual_seed(SEED + B * 100003 + D * 7 + signs)
        table = torch.randint(0, (1 << 14) + 1, (16, signs, D, L),
                              dtype=torch.int64, device=dev, generator=g)
        digits = torch.randint(0, 16, (B, D, W), dtype=torch.int8,
                               device=dev, generator=g)
        neg = torch.rand((B, D), device=dev, generator=g) < 0.5
        step = tbatch._select_bases(B, D, W, L)
        starts = [(i0, min(step, D - i0)) for i0 in range(0, D, step)]
        before = cuda_modexp.launches["table_select"]
        err = 0
        for i0, dc in starts:
            got = cuda_modexp.table_select(table, digits, neg, i0, dc)
            want = cuda_modexp.table_select_plain(table, digits, neg, i0, dc)
            check(torch.equal(got, want), "table_select B=%d D=%d W=%d "
                  "signs=%d: bases [%d, %d) differ from the plain version"
                  % (B, D, W, signs, i0, i0 + dc))
            err = max(err, int((got - want).abs().max()))
            del got, want
        check(cuda_modexp.launches["table_select"] == before + len(starts),
              "table_select: %d launches for %d chunks"
              % (cuda_modexp.launches["table_select"] - before, len(starts)))

        def run(fn):
            for i0, dc in starts:
                fn(table, digits, neg, i0, dc)

        ms = cuda_ms(lambda: run(cuda_modexp.table_select), 3)
        plain_ms = cuda_ms(lambda: run(cuda_modexp.table_select_plain), 1)
        nbytes = 8 * L * (D * B * W + 16 * signs * D) + B * D * (W + 1)
        bms, by = bound_ms(nbytes)
        print("table_select B=%d D=%d W=%d signs=%d L=%d: bit-equal over %d "
              "launches (chunks of %d bases); kernel %.3f ms, plain %.3f ms, "
              "bound %.3f ms (%s: %.3f GB)" % (B, D, W, signs, L,
                                              len(starts), step, ms,
                                              plain_ms, bms, by, nbytes / 1e9))
        check(ms >= bms, "table_select ran under its bound")
        out.append(dict(B=B, D=D, W=W, signs=signs, L=L, chunk=step,
                        launches=len(starts), max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, rows=B * D * W,
                        plain_rows=B * D * W, bound_ms=bms, bound_by=by))
        del table, digits, neg
    return out


def matvec_small_grids(keys, dev, card):
    """Phase 4, the matvec program (batch._matvec_dev, the shared table)
    against the parent's algorithm, one modexp a grid element and a tree
    (batch._pow_elems_dev, batch._tree_reduce_dev), at MATVEC_SHAPES'
    grids of each key: D seeded encrypted floats against a [B, D] float
    matrix through matvec's own grid build, the two ciphertexts equal mod
    n^2, each timed on CUDA events in turns (shared, per element, per
    element, shared) after its warm-up and capture. Returns the records."""
    from phe_tpu_torch import batch as tbatch
    from phe_tpu_torch import config
    from phe_tpu_torch.batch import EncryptedBatch

    out = []
    for pub in keys:
        dc = pub.device_context(dev)
        rstate = dc.rns_state()
        route = "limb" if rstate is None else "rns"
        bits = pub.n.bit_length()
        for B, D in MATVEC_SHAPES[bits]:
            g = np.random.default_rng(SEED + 31 * B + D + bits)
            a = EncryptedBatch.encrypt(pub, g.normal(0.0, 0.3, D).tolist(),
                                       device=dev)
            digits, neg, _ = a._grid(g.normal(0.0, 1.0, (B, D)))
            W = digits.shape[-1]
            mont, inv = a.mont[:D], a.inverse_mont()[:D]
            mask = config.to_device(neg, dev)
            digits = tbatch._digits_on(digits, dev)
            base = torch.where(mask[..., None], inv.expand(B, D, dc.L),
                               mont.expand(B, D, dc.L)).contiguous()
            runs = {
                "shared_table": lambda: tbatch._matvec_dev(
                    mont, inv if neg.any() else None, mask, digits, dc.ctx),
                "per_element": lambda: tbatch._tree_reduce_dev(
                    tbatch._pow_elems_dev(base, digits, dc.ctx,
                                          rstate).transpose(0, 1)
                    .contiguous(), dc.ctx)[0],
            }
            ints = {}
            for path, run in runs.items():
                for _ in range(3):  # warm-up, capture, replay
                    got = run()
                ints[path] = dc.export_ints(got)
            check(ints["shared_table"] == ints["per_element"],
                  "matvec %d-bit B=%d D=%d: the shared table's ciphertexts "
                  "differ from per-element modexps'" % (bits, B, D))
            turns = {path: [] for path in runs}
            for path in ("shared_table", "per_element", "per_element",
                         "shared_table"):
                one = cuda_ms(runs[path], 1)
                reps = max(1, min(20, int(MATVEC_MS / max(one, 1e-3))))
                turns[path].append(cuda_ms(runs[path], reps))
            print("matvec %d-bit (%s route, L = %d) B=%d D=%d W=%d: equal; "
                  "shared table %s ms, per-element modexps %s ms [%s]"
                  % (bits, route, dc.L, B, D, W,
                     " / ".join("%.3f" % t for t in turns["shared_table"]),
                     " / ".join("%.3f" % t for t in turns["per_element"]),
                     card))
            out.append(dict(bits=bits, route=route, L=dc.L, B=B, D=D, W=W,
                            shared_table_ms=turns["shared_table"],
                            per_element_ms=turns["per_element"]))
            del a, mont, inv, base, got
    return out


def ragged_sizes(sms):
    """{(E, rows a block, C): batches} of the ragged checks in the int8
    body: one row a block of E = 8 on 1, 7 and 9 rows; three rows a block
    of E = 8; full blocks of E = 8 and of E = 32, each at its smallest and
    largest batch."""
    sizes = {(8, 1, 1): (1, 7, 9), (8, 3, 1): (2 * sms + 1, 3 * sms - 1)}
    for E in (8, 32):
        sizes[E, E, 1] = ((sms - 1) * E + 1, sms * E - 1)
    return sizes


def check_ragged_pows(pub, dev, rng):
    """Phase 2, ragged batches of both limb-engine modexp forms at the
    2048-bit n^2 (L = 296; 64-bit exponents, window 4, the per-row
    schedules' first two all-zero and all-ones), value-equal to their
    plain versions and Python pow, at every (E, rows a block, C) the
    wrapper picks on this card (ragged_sizes): one row a block (1, 7 and 9
    rows) on every row; three rows a block of E = 8, and full blocks of
    E = 8 and of E = 32, each at the smallest and largest batch that takes
    it (a last block of 1 row, and of all but one), on their first rows
    and last two blocks. The REDC body is int8, held by the launch's
    private body argument."""
    from phe_tpu_torch import batch as tbatch
    from phe_tpu_torch.ops import cuda_modexp, cuda_rns
    from phe_tpu_torch.ops import montgomery as mg
    from phe_tpu_torch.utils import limbs as hl

    ctx, L, N = pub.device_context(dev).ctx, pub.device_context(dev).L, \
        pub.nsquare
    R = 1 << (14 * L)
    R_inv = pow(R, -1, N)
    sms = cuda_rns._sms(dev)
    sizes = ragged_sizes(sms)
    for tile, Bs in sizes.items():
        check(all(pow_tile(L, B) == tile for B in Bs),
              "ragged modexp batches %s do not take %s" % (Bs, tile))
    rows = max(max(Bs) for Bs in sizes.values())
    checked = sorted(set(range(9)).union(*(
        range(B - 2 * r, B) for (_, r, _), Bs in sizes.items() for B in Bs
        if B > 9)))
    xs = [rng.randrange(0, 2 * N) for _ in range(rows)]
    base = mg._tensor(hl.ints_to_limbs(xs, L), dev)
    es = [0, (1 << 64) - 1] + [rng.getrandbits(64) for _ in range(rows - 2)]
    e_shared = rng.getrandbits(64) | 1 << 63
    digits = torch.as_tensor(tbatch._digits_rows(es, 64), device=dev)
    sdig = torch.as_tensor(mg.exponent_digits(e_shared, 64), device=dev)
    t0 = time.perf_counter()
    ref = mg.mont_pow_shared_plain(base[checked], sdig, ctx)
    ref_vec = mg.mont_pow_plain(base[checked], digits[checked], ctx)
    sync()
    plain_s = time.perf_counter() - t0
    want = [pow(xs[i] * R_inv, e_shared, N) * R % N for i in checked]
    want_vec = [pow(xs[i] * R_inv, es[i], N) * R % N for i in checked]

    def values(t):
        return [v % N for v in hl.limbs_to_ints(t.cpu().numpy())]

    check(values(ref) == want and values(ref_vec) == want_vec,
          "the plain modexps differ from Python pow")
    for B in sorted(B for Bs in sizes.values() for B in Bs):
        b = base[:B].contiguous()
        got = cuda_modexp._pow_launch(b, sdig, ctx, mg.DEFAULT_WINDOW, False,
                                      True)
        got_vec = cuda_modexp._pow_launch(b, digits[:B].contiguous(), ctx,
                                          mg.DEFAULT_WINDOW, True, True)
        at = [i for i, r in enumerate(checked) if r < B]
        rs = [checked[i] for i in at]
        check(values(got[rs]) == [want[i] for i in at]
              and values(got_vec[rs]) == [want_vec[i] for i in at]
              and int(got.min()) >= 0 and int(got.max()) <= 1 << 14
              and int(got_vec.min()) >= 0 and int(got_vec.max()) <= 1 << 14,
              "mont_pow L=%d: a ragged batch of %d rows differs from the "
              "plain version" % (L, B))
    print("mont_pow_shared, mont_pow L=%d: ragged batches value-equal to "
          "the plain versions and Python pow on %d checked rows, %d SMs: %s "
          "(plain %.1f s)"
          % (L, len(checked), sms, "; ".join(
              "E = %d, %d rows a block, clusters of %d: %s rows" % (
                  E, r, C, ", ".join(map(str, Bs)))
              for (E, r, C), Bs in sizes.items()), plain_s))


def default_key_path(dev, card, totals):
    """Phase 3, the default key size (keys.DEFAULT_KEYSIZE: the fixed
    3072-bit key, benchmarks.fixed_key(3072)): key constants, then the
    REDC matrices of its five Montgomery contexts, each timed; a warm-up
    round trip of 8 rows; BATCH seeded values encrypted and decrypted,
    each with its launches; a pinned-r batch against raw_encrypt. Returns
    the key."""
    import phe_tpu_torch as pt
    from phe_tpu_torch import benchmarks
    from phe_tpu_torch.batch import EncryptedBatch
    from phe_tpu_torch.keys import DEFAULT_KEYSIZE

    pub, priv = benchmarks.fixed_key(DEFAULT_KEYSIZE)
    t0 = time.perf_counter()
    dc, pdc = pub.device_context(dev), priv.device_context(dev)
    k = dc.rns_state().rsys.k
    pdc.rns_state()
    t_keys = time.perf_counter() - t0
    t_redc = redc_seconds(key_contexts(dc, pdc))
    values = [float(v) for v in
              np.random.default_rng(SEED + 3).uniform(-1e6, 1e6, BATCH)]
    warm = EncryptedBatch.encrypt(pub, values[:8], device=dev)
    check(warm.decrypt(priv) == values[:8], "%d-bit warm-up round trip "
          "failed" % DEFAULT_KEYSIZE)
    batch, t_enc, enc = run_step(
        lambda: EncryptedBatch.encrypt(pub, values, device=dev), totals)
    expect_launches("%d-bit encrypt" % DEFAULT_KEYSIZE, enc,
                    {"mont_mul": 1, "mont_mul_const": 1, "rns_ladder": 1})
    decrypted, t_dec, dec = run_step(lambda: batch.decrypt(priv), totals)
    expect_launches("%d-bit decrypt" % DEFAULT_KEYSIZE, dec,
                    {"mont_mul": 3, "mont_mul_const": 6, "rns_ladder": 2})
    check(decrypted == values, "%d-bit decrypt(encrypt(x)) != x for %d of "
          "%d rows" % (DEFAULT_KEYSIZE, sum(a != b for a, b in
                                             zip(decrypted, values)), BATCH))
    few = values[:8]
    rng = random.Random(SEED + 3)
    rs = [rng.randrange(1, pub.n) for _ in few]
    pinned = EncryptedBatch.encrypt(pub, few, r_values=rs, device=dev)
    encs = pt.EncodedNumber.encode_many(pub, few)
    check(pinned.ciphertext_ints(be_secure=False)
          == [pub.raw_encrypt(e.encoding, r_value=r)
              for e, r in zip(encs, rs)],
          "%d-bit pinned-r ciphertexts differ from the host's raw_encrypt"
          % DEFAULT_KEYSIZE)
    print("%d-bit key (n^2: k = %d, ladder E = %d; L = %d, mont_mul %s): "
          "key constants %.3f s, REDC matrices of its five Montgomery "
          "contexts %.3f s; B=%d: decrypt(encrypt(x)) == x for every row, "
          "pinned-r batch of %d equals raw_encrypt; encrypt %.1f ops/s "
          "(%.3f s), decrypt %.1f ops/s (%.3f s); launches %s, %s [%s]"
          % (DEFAULT_KEYSIZE, k, ladder_elems(k, BATCH), dc.L,
             tile_text(dc.L, BATCH), t_keys, t_redc, BATCH, len(few),
             BATCH / t_enc, t_enc, BATCH / t_dec, t_dec, json.dumps(enc),
             json.dumps(dec), card))
    return pub, priv


def decrypt_all(batch, priv):
    """Decrypt in BATCH-row slices (the decrypt ladders' scratch grows with
    the rows)."""
    from phe_tpu_torch.batch import EncryptedBatch

    out = []
    for lo in range(0, len(batch), BATCH):
        part = EncryptedBatch(batch.public_key, batch.mont[lo : lo + BATCH],
                              batch.exponents[lo : lo + BATCH])
        out += part.decrypt(priv)
    return out


def arithmetic_path(pub, priv, dev, card, totals):
    """Phase 4: the homomorphic algebra and the two applications through
    their entry points, each step checked exactly against the host.
    Returns {step: rate}."""
    from fractions import Fraction

    from phe_tpu_torch.batch import EncryptedBatch
    from phe_tpu_torch.models import (
        EncryptedScorer,
        FederatedClient,
        aggregate_encrypted_gradients,
    )

    g = np.random.default_rng(SEED + 4)
    dc = pub.device_context(dev)
    nsq = pub.nsquare
    chunk = EncryptedBatch._INVERSE_CHUNK
    rates = {}

    def floats(lo, hi, rows):
        return [float(v) for v in g.uniform(lo, hi, rows)]

    def report(step, rows, seconds, counts):
        rates[step] = rows / seconds
        print("%s: %d rows in %.4f s, %.1f rows/s; launches %s [%s]"
              % (step, rows, seconds, rows / seconds, json.dumps(counts),
                 card))

    def exact_sum(terms):
        return float(sum(terms, Fraction(0)))

    # add at equal exponents: one list for both operands (bench.py's add).
    xs = floats(-1e6, 1e6, ADD_ROWS)
    ct = EncryptedBatch.encrypt(pub, xs, obfuscation="none", device=dev)
    ct2 = EncryptedBatch.encrypt(pub, xs, obfuscation="none", device=dev)
    s, sec, n = run_step(lambda: ct + ct2, totals)
    expect_launches("add", n, {"mont_mul": 1})
    report("add, equal exponents", ADD_ROWS, sec, n)
    profiled("add over %d rows" % ADD_ROWS, lambda: ct + ct2, card)
    check(decrypt_all(s, priv) == [x + x for x in xs],
          "add: decrypt(x + x) != x + x")
    idx = sorted(random.Random(SEED).sample(range(ADD_ROWS),
                                              min(256, ADD_ROWS)))
    c1, c2 = dc.export_ints(ct.mont[idx]), dc.export_ints(ct2.mont[idx])
    check(dc.export_ints(s.mont[idx]) == [a * b % nsq for a, b in zip(c1, c2)],
          "add: ciphertexts differ from the host's c1 c2 mod n^2")
    del ct, ct2, s

    # add with alignment on both sides, add_scalars, mul_scalars.
    xa, yb = floats(-1e6, 1e6, MUL_ROWS), floats(-1e-3, 1e-3, MUL_ROWS)
    a = EncryptedBatch.encrypt(pub, xa, obfuscation="none", device=dev)
    b = EncryptedBatch.encrypt(pub, yb, obfuscation="none", device=dev)
    s, sec, n = run_step(lambda: a + b, totals)
    expect_launches("add aligned", n, {"rns_ladder_vec": 2, "mont_mul": 1})
    report("add, aligned", MUL_ROWS, sec, n)
    check(decrypt_all(s, priv) == [x + y for x, y in zip(xa, yb)],
          "aligned add: decrypt(x + y) != x + y")
    sc = floats(-1e-3, 1e-3, MUL_ROWS)
    s, sec, n = run_step(lambda: a + sc, totals)
    expect_launches("add_scalars", n, {"rns_ladder_vec": 1,
                                       "mont_mul_const": 1, "mont_mul": 1})
    report("add_scalars, aligned", MUL_ROWS, sec, n)
    check(decrypt_all(s, priv) == [x + y for x, y in zip(xa, sc)],
          "add_scalars: decrypt(x + s) != x + s")
    sc = floats(-100.0, 100.0, MUL_ROWS)
    s, sec, n = run_step(lambda: a * sc, totals)
    mm, mc = inverse_launches(a.mont.shape[0], chunk)
    expect_launches("mul_scalars", n, {"rns_ladder_vec": 1, "mont_mul": mm,
                                       "mont_mul_const": mc})
    report("mul_scalars, mixed sign", MUL_ROWS, sec, n)
    check(decrypt_all(s, priv) == [x * y for x, y in zip(xa, sc)],
          "mul_scalars: decrypt(x * s) != x * s")
    del a, b, s

    # sum and dot at mixed exponents.
    xs = [float(v) for v in 10.0 ** g.uniform(-3, 6, BATCH)
          * g.choice([-1.0, 1.0], BATCH)]
    e = EncryptedBatch.encrypt(pub, xs, obfuscation="none", device=dev)
    s, sec, n = run_step(e.sum, totals)
    expect_launches("sum", n, {"rns_ladder_vec": 1,
                               "mont_mul": tree_depth(BATCH)})
    report("sum, mixed exponents", BATCH, sec, n)
    check(s.decrypt(priv) == [exact_sum(map(Fraction, xs))],
          "sum: not the exactly rounded sum")
    w = floats(-100.0, 100.0, BATCH)
    s, sec, n = run_step(lambda: e.dot(w), totals)
    mm, mc = inverse_launches(e.mont.shape[0], chunk)
    expect_launches("dot", n, {"rns_ladder_vec": 2,
                               "mont_mul": mm + tree_depth(BATCH),
                               "mont_mul_const": mc})
    report("dot, mixed exponents and signs", BATCH, sec, n)
    check(s.decrypt(priv) == [exact_sum(Fraction(x) * Fraction(y)
                                        for x, y in zip(xs, w))],
          "dot: not the exactly rounded dot product")
    del e, s

    # Encrypted logistic-regression scoring (models/logreg.py).
    coef = g.normal(size=LR_FEATURES)
    intercept = float(g.normal())
    X = g.normal(size=(LR_EXAMPLES, LR_FEATURES))
    scorer = EncryptedScorer.from_model(pub, coef, intercept, device=dev)
    s, sec, n = run_step(lambda: scorer.encrypted_scores(X), totals)
    D = LR_FEATURES + 1
    # The shared table: the weights' and inverses' tables (14 products),
    # one select and a 5-level tree over the 21 weights, Horner's 5
    # products a window after the first of the grid's 24; besides, the
    # batch inversion of the 32 bucketed weights (a 5-level scan and its
    # product; 3 constant products).
    expect_launches("LR scoring", n, {"table_select": 1,
                                      "mont_mul": 6 + 14 + 5 + 5 * 23,
                                      "mont_mul_const": 3})
    report("LR scoring, %d x %d grid" % (LR_EXAMPLES, D), LR_EXAMPLES * D,
           sec, n)
    weights = [Fraction(float(v)) for v in coef] + [Fraction(intercept)]
    check(s.decrypt(priv) == [
        exact_sum(Fraction(x) * wt for x, wt in zip(list(row) + [1.0],
                                                    weights))
        for row in X.tolist()], "LR scoring: not the exactly rounded X w + b")

    # Federated aggregation (models/federated.py), per-client magnitudes
    # 1e-6 ... 1e6, so the exponents align.
    clients = [
        FederatedClient("client%d" % c, g.normal(size=(4, BATCH)),
                        g.normal(size=4) * 10.0 ** (3 * c - 6), pub,
                        device=dev)
        for c in range(FL_CLIENTS)
    ]
    grads = [c.gradient() for c in clients]
    encrypted = [c.encrypted_gradient() for c in clients]
    s, sec, n = run_step(lambda: aggregate_encrypted_gradients(encrypted),
                         totals)
    check(n.get("mont_mul") == tree_depth(FL_CLIENTS)
          and 1 <= n.get("rns_ladder_vec", 0) <= FL_CLIENTS
          and set(n) == {"mont_mul", "rns_ladder_vec"},
          "FL aggregation launched %s" % json.dumps(n))
    report("FL aggregation, %d x %d" % (FL_CLIENTS, BATCH),
           FL_CLIENTS * BATCH, sec, n)
    check(decrypt_all(s, priv)
          == [exact_sum(Fraction(float(gr[d])) for gr in grads)
              for d in range(BATCH)],
          "FL aggregation: not the exactly rounded column sums")
    del encrypted, s

    # Short-obfuscated encryption: the key's first batch also draws h.
    xs = floats(-1e6, 1e6, BATCH)
    enc = lambda: EncryptedBatch.encrypt(pub, xs, obfuscation="short",
                                         device=dev)
    check(dc._h_mont is None, "short obfuscation's h was drawn before")
    first, sec, n = run_step(enc, totals)
    expect_launches("short encrypt, first batch", n, {
        "mont_mul_const": 2, "mont_pow_shared": 1, "mont_pow": 1,
        "mont_mul": 1})
    report("short encrypt, first batch", BATCH, sec, n)
    second, sec, n = run_step(enc, totals)
    expect_launches("short encrypt", n, {"mont_mul_const": 1, "mont_pow": 1,
                                         "mont_mul": 1})
    report("short encrypt", BATCH, sec, n)
    check(first.decrypt(priv) == xs and second.decrypt(priv) == xs,
          "short encrypt: decrypt(encrypt(x)) != x")
    nude = EncryptedBatch.encrypt(pub, xs[:64], obfuscation="none",
                                  device=dev).ciphertext_ints(False)
    for batch in (first, second):
        got = dc.export_ints(batch.mont[:64])
        check(all(x != y for x, y in zip(got, nude)),
              "short encrypt: a ciphertext equals its nude encryption")
    return rates


def check_ragged_ladders(pub, dev, rng):
    """Phase 2, ragged batches at the 2048-bit n^2 geometry (k = 304): the
    shared ladder (the encrypt's exponent n, window 5) and the per-element
    ladder (64-bit schedules, window 4, the first two all-zero and
    all-ones), bit-equal to their plain versions. At E = 8, batches of 1,
    7 and 9 rows on every row; at E = 32, the smallest batches that take
    it on this card with a last block of 1 and of 31 elements, on their
    first 9 rows and their last two blocks."""
    from phe_tpu_torch import batch as tbatch
    from phe_tpu_torch.ops import cuda_rns, rns
    from phe_tpu_torch.ops import montgomery as mg
    from phe_tpu_torch.utils import limbs as hl

    dc = pub.device_context(dev)
    st, rsys = dc.rns_state(), dc.rns_state().rsys
    sms = cuda_rns._sms(dev)
    sizes = {8: (1, 7, 9), 32: ((sms - 1) * 32 + 1, sms * 32 - 1)}
    for E, Bs in sizes.items():
        check(all(ladder_elems(rsys.k, B) == E for B in Bs),
              "ragged ladder batches %s do not take E = %d" % (Bs, E))
    rows = max(sizes[32])
    # The rows each batch is checked on: all of an E = 8 batch; the head
    # and the last two blocks (the partial one and a full one) at E = 32.
    head = list(range(max(sizes[8])))
    tail = list(range(min(sizes[32]) - 1 - 32, rows))
    checked = head + tail
    xs = [rng.randrange(1, pub.nsquare) for _ in range(rows)]
    x = rns.to_rns(mg._tensor(hl.ints_to_limbs(xs, dc.L), dev), st.conv,
                   rsys).contiguous()
    es = [0, (1 << 64) - 1] + [rng.getrandbits(64) for _ in range(rows - 2)]
    digits = torch.as_tensor(tbatch._digits_rows(es, 64), device=dev)
    vec = dict(entry_res=st.entry_mont, exit_res=st.exit_r)
    t0 = time.perf_counter()
    ref = rns.ladder_plain(x[checked], dc.n_digits, rsys, window=5)
    ref_vec = rns.ladder_vec_plain(x[checked], digits[checked], rsys, **vec)
    sync()
    plain_s = time.perf_counter() - t0
    for B in sizes[8] + sizes[32]:
        xb = x[:B].contiguous()
        got = cuda_rns.ladder(xb, dc.n_digits, rsys, window=5)
        got_vec = cuda_rns.ladder_vec(xb, digits[:B].contiguous(), rsys, **vec)
        at = [i for i, r in enumerate(checked) if r < B]
        rs = [checked[i] for i in at]
        check(torch.equal(got[rs], ref[at])
              and torch.equal(got_vec[rs], ref_vec[at]),
              "rns_ladder k=%d: a ragged batch of %d rows differs from the "
              "plain version" % (rsys.k, B))
    print("rns_ladder, rns_ladder_vec k=%d: ragged batches bit-equal to the "
          "plain versions, %s rows (E = 8) on every row, %s rows (E = 32, "
          "%d SMs) on their first %d rows and last two blocks (plain %.1f s "
          "for %d rows)" % (rsys.k, ", ".join(map(str, sizes[8])),
                            ", ".join(map(str, sizes[32])), sms, len(head),
                            plain_s, len(checked)))


def tensor_core_sass(source, kernel, elems, int_pipe=False):
    """Phase 1, a kernel's instructions as the card runs them: every
    instantiation <kVec, E> (<kVec, E, kMxu> with int_pipe) of `kernel` in
    cuobjdump -sass of the library built from `source` holds int8
    tensor-core MMAs (IMMA) and no __dp4a (IDP4A); with int_pipe, each
    integer-pipe instantiation (kMxu false, E = 8, 32 and the one-row
    tile's cluster form, E = 1) holds neither.
    {instantiation: (IMMA count, IDP4A count)}."""
    import os
    import subprocess

    from phe_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build._paths(source)[1]],
                          check=True, capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            # kernel<kVec, E(, kMxu)>, mangled as ...ILb<kVec>ELi<E>E...
            m = re.search(kernel + r"ILb([01])ELi(\d+)E(?:Lb([01])E)?", line)
            name = m and "%s<%s, %s%s>" % (
                kernel, ("false", "true")[int(m.group(1))], m.group(2),
                "" if m.group(3) is None
                else (", int", ", mxu")[int(m.group(3))])
            if name:
                counts[name] = [0, 0]
        elif name:
            counts[name][0] += "IMMA" in line
            counts[name][1] += "IDP4A" in line
    from phe_tpu_torch.ops import cuda_modexp

    want = 2 * len(elems) + (2 * len(cuda_modexp.INT_ELEMS) if int_pipe else 0)
    check(len(counts) == want, "cuobjdump shows %d %s instantiations, not %d"
          % (len(counts), kernel, want))
    for name, (imma, dp4a) in sorted(counts.items()):
        print("%s SASS %s: %d IMMA, %d IDP4A" % (source, name, imma, dp4a))
        if name.endswith(", int>"):
            check(imma == 0 and dp4a == 0, "%s, the integer-pipe body, runs "
                  "products on the tensor cores or __dp4a" % name)
        else:
            check(imma > 0 and dp4a == 0, "%s does not run its digit "
                  "products on the int8 tensor cores alone" % name)
    return counts


def ptxas_report(log, kernel):
    """{instantiation: (registers, spill-store bytes, spill-load bytes)}
    of `kernel` in a library's ptxas -v log (its entry functions named
    as tensor_core_sass names them)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(kernel + r"ILb([01])ELi(\d+)E", line)
            name = m and "%s<%s, %s>" % (
                kernel, ("false", "true")[int(m.group(1))], m.group(2))
        elif name and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            out[name] = [0, int(m.group(1)), int(m.group(2))]
        elif name and "Used" in line and "registers" in line:
            out.setdefault(name, [0, 0, 0])[0] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            name = None
    return {n: tuple(v) for n, v in out.items()}


# The ladder shapes timed parent against change (label, key bits, the
# modulus n^2 or p^2, rows, per-element exponents): the r^n ladders of the
# 2048- and 3072-bit keys at the encrypt batch and at the short call, the
# decrypt halves of the 2048- and 8192-bit keys, and the
# alignment's per-element ladders.
LADDER_TURNS = (
    ("r^n k=304", 2048, "n2", BATCH, False),
    ("r^n k=456", 3072, "n2", BATCH, False),
    ("p-1 k=152", 2048, "p2", BATCH, False),
    ("r^n k=304 short", 2048, "n2", 4096, False),
    ("r^n k=456 short", 3072, "n2", 4096, False),
    ("p-1 k=624", 8192, "p2", LIMB_ROWS, False),
    ("p-1 k=624 wide", 8192, "p2", 4224, False),
    ("vec k=304", 2048, "n2", BATCH, True),
    ("vec k=456", 3072, "n2", BATCH, True),
)

# One turn, run by a checkout's own Python from its root: the ladder at
# each shape through the public wrappers (whose packing and kernel are
# that checkout's), on seeded inputs, its CUDA-event milliseconds and a
# digest of its residues.
_TURN = r"""
import hashlib, json, sys, torch
from phe_tpu_torch import benchmarks
from phe_tpu_torch.ops import cuda_rns, rns
dev = torch.device("cuda")
out = {}
for label, bits, which, rows, vec in json.loads(sys.argv[1]):
    pub, priv = benchmarks.fixed_key(bits)
    M = pub.nsquare if which == "n2" else priv.psquare
    e = pub.n if which == "n2" else priv.p - 1
    sys_ = rns.build_rns(M, dev)
    g = torch.Generator().manual_seed(rows + sys_.k)
    x = (torch.randint(0, 1 << 14, (rows, sys_.cpad), generator=g)
         % sys_.m.cpu()).to(dev).contiguous()
    if vec:
        d = torch.randint(0, 16, (rows, 16), generator=g,
                          dtype=torch.int8).to(dev)
        run = lambda: cuda_rns.ladder_vec(x, d, sys_, window=4)
    else:
        d = torch.as_tensor(rns.rns_pow_digits(e, e.bit_length(), 5),
                            dtype=torch.int64, device=dev)
        run = lambda: cuda_rns.ladder(x, d, sys_, window=5)
    y = run()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(2):
        run()
    b.record()
    torch.cuda.synchronize()
    out[label] = [a.elapsed_time(b) / 2, sys_.k, d.shape[-1],
                  hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()]
print("TURN " + json.dumps(out))
"""


def ladder_turns(parent, card):
    """Phase 2, with --parent: the ladder of this checkout against the one
    at `parent` (a checkout's root) at LADDER_TURNS' shapes, each side in
    a process of its own from its own root, in turns parent, change,
    change, parent, beside ladder_bound; the residues of every turn are
    the same. {label: record}."""
    import subprocess

    from phe_tpu_torch.ops import cuda_rns

    here = os.path.dirname(os.path.abspath(__file__))
    shapes = json.dumps(LADDER_TURNS)

    def turn(root):
        env = dict(os.environ, PYTHONPATH=root)
        got = subprocess.run([sys.executable, "-c", _TURN, shapes], cwd=root,
                             env=env, capture_output=True, text=True,
                             timeout=1200)
        line = [ln for ln in got.stdout.splitlines() if ln.startswith("TURN ")]
        check(got.returncode == 0 and line, "ladder turn in %s failed:\n%s"
              % (root, got.stdout[-3000:] + got.stderr[-3000:]))
        return json.loads(line[-1][5:])

    turns = [("parent", turn(os.path.abspath(parent))), ("change", turn(here)),
             ("change", turn(here)), ("parent", turn(os.path.abspath(parent)))]
    sms = cuda_rns._sms(torch.device("cuda"))
    record = {}
    for label, bits, which, rows, vec in LADDER_TURNS:
        ms = {"parent": [], "change": []}
        for side, t in turns:
            ms[side].append(t[label][0])
        _, k, n_windows, _ = turns[0][1][label]
        check(len({t[label][3] for _, t in turns}) == 1,
              "ladder turns %s: parent and change residues differ" % label)
        bms, by = ladder_bound(rows, k, n_windows, 4 if vec else 5, vec=vec)
        E = cuda_rns._elems(k, rows, sms)
        ratio = sum(ms["change"]) / sum(ms["parent"])
        print("ladder turns %s, %d rows (E = %d, clusters of %d): parent %s "
              "ms, change %s ms (change / parent %.3f), bound %.3f ms (%s); "
              "residues equal [%s]"
              % (label, rows, E, cuda_rns.CLUSTER,
                 " ".join("%.3f" % v for v in ms["parent"]),
                 " ".join("%.3f" % v for v in ms["change"]), ratio, bms, by,
                 card))
        record[label] = dict(k=k, rows=rows, elems=E,
                             width=cuda_rns.CLUSTER, parent_ms=ms["parent"],
                             change_ms=ms["change"], change_over_parent=ratio,
                             bound_ms=bms, bound_by=by)
    return record


def one_product_split(rsys, rows, dev, card, yardstick=False, digits=None):
    """Phase 2, what one ladder product's time follows. Window 1 runs two
    products a row (entry and exit) and two more for each digit, so the
    difference between 31 zero digits (64 products) and none (2) is 62
    products without the launch's fixed costs. Each width E whose block
    fits runs both on the same rows, with the same MMA and int32 work and
    the extension matrices read from L2 once per cluster-product (each
    block copies 1 / width of every stage to the cluster's blocks), so
    their L2 bytes fall as 1 / (E width). With digits (a window-5 schedule), the whole
    ladder at each width too, beside ladder_bound. With yardstick,
    torch._int_mm over both extensions' GEMMs alone ([B, 2k] x
    [2k, 3(k+8)] twice) beside it: no one PyTorch call computes the
    ladder, and the port never calls it."""
    from phe_tpu_torch.ops import cuda_rns
    from phe_tpu_torch.ops import limb_math as lm

    k = rsys.k
    K1p, Kp = cuda_rns._geometry(k)
    g = np.random.default_rng(SEED + 5)
    x = (torch.as_tensor(g.integers(0, 1 << 14, (rows, rsys.cpad)),
                         device=dev) % rsys.m).contiguous()
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    zeros = torch.zeros(31, dtype=torch.int64, device=dev)
    outs, fulls, split = [], [], {}
    for E in cuda_rns.ELEMS:
        if cuda_rns._smem(k, E) > cuda_rns.SMEM_LIMIT:
            continue
        run = lambda d, w=1: cuda_rns._launch(x, d, rsys, w, None, None,
                                              False, E)
        outs.append(run(zeros))
        ms2, ms64 = cuda_ms(lambda: run(none), 5), cuda_ms(lambda: run(zeros), 3)
        ns = 1e6 * (ms64 - ms2) / (62 * rows)
        width = cuda_rns.CLUSTER
        blocks = -(-rows // E)
        l2_bytes = -(-blocks // width) * 62 * (2 * 3 * K1p * Kp)
        split[E] = dict(ms_2_products=ms2, ms_64_products=ms64,
                        ns_per_element_product=ns, width=width,
                        l2_kb_per_element_product=(
                            2 * 3 * K1p * Kp / (E * width) / 1e3),
                        l2_tb_per_s=l2_bytes / ((ms64 - ms2) * 1e9))
        print("one product, k=%d, E=%d, clusters of %d: %.4f ms for 2 "
              "products a row, %.4f ms for 64, over %d rows (%d blocks): "
              "%.3f ns an element-product; extension matrices from L2 at "
              "%.3f TB/s, %.1f KB an element-product [%s]"
              % (k, E, width, ms2, ms64, rows, blocks, ns,
                 split[E]["l2_tb_per_s"],
                 split[E]["l2_kb_per_element_product"], card))
        if digits is not None:
            fulls.append(run(digits, 5))
            ms = split[E]["ms_ladder"] = cuda_ms(lambda: run(digits, 5), 1)
            bms, by = ladder_bound(rows, k, len(digits), 5)
            split[E]["bound_ms_ladder"] = bms
            print("ladder, k=%d, E=%d, %d windows of 5: %.3f ms over %d rows, "
                  "bound %.3f ms (%s) [%s]"
                  % (k, E, len(digits), ms, rows, bms, by, card))
    check(all(torch.equal(o, outs[0]) for o in outs)
          and all(torch.equal(o, fulls[0]) for o in fulls),
          "the ladder's widths disagree on the same rows")
    bms, by = ladder_bound(rows, k, 31, 1)
    bms2, _ = ladder_bound(rows, k, 0, 1)
    print("one product bound, k=%d, %d rows: %.3f ns an element-product (%s); "
          "the wrapper picks E = %d"
          % (k, rows, 1e6 * (bms - bms2) / (62 * rows), by,
             ladder_elems(k, rows)))
    if not yardstick:
        return split
    dig = torch.as_tensor(g.integers(0, 128, (rows, 2 * k)), dtype=torch.int8,
                          device=dev)
    ws = (rsys.w_ext1.t(), rsys.w_ext2.t())
    mm = lambda: [torch._int_mm(dig, w) for w in ws]
    got = mm()
    check(all(torch.equal(o[:64].long(), lm.matmul_exact(dig[:64], w))
              for o, w in zip(got, ws)), "torch._int_mm differs from the "
          "exact digit product")
    ms = cuda_ms(mm, 5)
    print("torch._int_mm yardstick, k=%d: both extensions' GEMMs [%d, %d] x "
          "[%d, %d] %.4f ms, %.3f ns an element-product [%s]"
          % (k, rows, 2 * k, 2 * k, 3 * (k + 8), ms, 1e6 * ms / rows, card))
    return split


def chain_bound(body, K, n):
    """(least ms, "operations") for K iterations of a chain body over n
    elements: the busier of the two pipes of CHAIN_ISSUE at
    INT32_OPS_PER_S; the two pipes issue side by side. Bytes (one word in,
    one out an element) are negligible."""
    return bound_ms(8 * n, int32_ops=K * n * max(CHAIN_ISSUE[body]))


def check_issue_chain(dev):
    """Phase 2, the issue-rate chain: each body on the full [256, 512] tile
    at K = CHAIN_K, on the calibration's inputs, bit-equal to its plain
    version on the card and no faster than its bound (a faster one would
    show CHAIN_ISSUE stale). Returns one record per body."""
    from phe_tpu_torch import microbench
    from phe_tpu_torch.ops import cuda_microbench as cm

    g = np.random.default_rng(microbench.SEED)
    x = torch.as_tensor(g.integers(1, 1 << 14, (microbench.R, microbench.TB),
                                   dtype=np.int32), device=dev)
    out = []
    for body in cm.BODIES:
        got = cm.issue_chain(x, body, CHAIN_K)
        sync()
        t0 = time.perf_counter()
        ref = cm.issue_chain_plain(x, body, CHAIN_K)
        sync()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        err = int((got.long() - ref.long()).abs().max())
        check(err == 0, "vpu_microbench %s: kernel bits differ from the "
              "plain version" % body)
        ms = cuda_ms(lambda: cm.issue_chain(x, body, CHAIN_K), 10)
        bms, by = chain_bound(body, CHAIN_K, x.numel())
        print("vpu_microbench %s [%d, %d] K=%d: bit-equal; kernel %.4f ms "
              "(%.2fx its bound), plain %.1f ms, bound %.4f ms (%s; ALU, FMA "
              "pipe instructions an iteration %s)"
              % (body, x.shape[0], x.shape[1], CHAIN_K, ms, ms / bms,
                 plain_ms, bms, by, CHAIN_ISSUE[body]))
        check(ms >= bms, "vpu_microbench %s ran under its bound: "
              "CHAIN_ISSUE no longer matches the kernel's SASS" % body)
        out.append(dict(body=body, K=CHAIN_K, rows=x.shape[0],
                        cols=x.shape[1], max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, plain_rows=x.shape[0],
                        bound_ms=bms, bound_by=by))
    return out


def calibration(card, totals):
    """Phase 5: microbench.main() with its launches counted, its two rates
    beside INT32_OPS_PER_S (the bounds' published rate) and the H100 row
    of profiling.py."""
    from phe_tpu_torch import microbench, profiling
    from phe_tpu_torch.ops import cuda_microbench as cm

    rates, sec, n = run_step(microbench.main, totals)
    # Per body: one warm-up launch and 8 timed launches at each K.
    expect_launches("calibration", n, {"vpu_microbench": 18 * len(cm.BODIES)})
    (mul_row, op_row, _), kind, assumed = profiling.chip_peaks()
    print("calibration (%.1f s): int32_mul_per_s %.6g (%.1f %% of the "
          "published %.6g; profiling.py's H100 row %.6g), "
          "int32_mixed_op_per_s %.6g (%.1f %% of the published rate; row "
          "%.6g); peaks for %s, assumed=%s [%s]"
          % (sec, rates["int32_mul_per_s"],
             100 * rates["int32_mul_per_s"] / INT32_OPS_PER_S,
             INT32_OPS_PER_S, mul_row, rates["int32_mixed_op_per_s"],
             100 * rates["int32_mixed_op_per_s"] / INT32_OPS_PER_S, op_row,
             kind, assumed, card))
    return rates


def _busy_us(kernels):
    """Microseconds covered by the union of the kernels' time ranges."""
    from paillier_bench import devicetrace

    return sum(b - a for a, b in devicetrace._union(
        [(e.time_range.start, e.time_range.end) for e in kernels]))


def benchmark_phase(pub, priv, dev, card, totals):
    """Phase 6: bench.main (BENCH_RUNS timed, BENCH_WARMUP untimed streamed
    passes per op), benchmarks.main at 1024 and 2048 bits with --mem, and
    one BATCH-row encrypt and decrypt under profiling.trace."""
    from phe_tpu_torch import bench, benchmarks
    from phe_tpu_torch.batch import EncryptedBatch

    lines, sec, n = run_step(
        lambda: bench.main(runs=BENCH_RUNS, warmup=BENCH_WARMUP), totals)
    print("bench.main: %.1f s, %d timed and %d untimed streamed passes per "
          "op; launches %s [%s]" % (sec, BENCH_RUNS, BENCH_WARMUP,
                                   json.dumps(n), card))
    check(all(line["device"] == torch.cuda.get_device_name(dev)
              for line in lines.values()), "bench rows do not name the card")
    _, sec, n = run_step(lambda: benchmarks.main(
        ["--key-sizes", "1024,2048", "--mem"]), totals)
    print("benchmarks.main: %.1f s; launches %s [%s]"
          % (sec, json.dumps(n), card))

    values = [float(v) for v in
              np.random.default_rng(SEED + 6).uniform(-1e6, 1e6, BATCH)]
    out = profiled("%d-row encrypt and decrypt" % BATCH, lambda: (
        EncryptedBatch.encrypt(pub, values, device=dev).decrypt(priv)), card)
    check(out == values, "profiled round trip: decrypt(encrypt(x)) != x")


# Each profiled() window's numbers, by its label.
PROFILES = {}


def profiled(what, fn, card):
    """fn() under profiling.trace: its host-clock time, the card's busy
    share, the CUDA runtime calls that launch work or wait (kernel and
    graph launches, copies, synchronisations) with their counts, the top
    ten kernels by device time and every kernel of the port's own are
    printed and kept in PROFILES; fn's result is returned. The copies of
    the program's spans on the card's timeline are no work of the card's
    and are left out."""
    from phe_tpu_torch import profiling

    with profiling.trace() as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in profiling.SPANS]
    api = {a.key: a.count for a in prof.key_averages()
           if a.device_type == torch.autograd.DeviceType.CPU
           and re.match(r"cu(da)?(Launch|GraphLaunch|Memcpy|Stream"
                        r"Synchronize|DeviceSynchronize|EventSynchronize)",
                        a.key)}
    record = PROFILES[what] = {"host_ms": wall_us / 1e3, "api": api,
                               "kernel_events": len(kernels)}
    print("profiler: %s, CUDA runtime calls %s" % (what, json.dumps(api)))
    if not kernels:
        print("profiler: no device time over the %s (%.1f ms on the host "
              "clock) [%s]" % (what, wall_us / 1e3, card))
        return out
    busy = _busy_us(kernels)
    record.update(busy_ms=busy / 1e3, busy_share=busy / wall_us)
    print("profiler: %s, %.1f ms on the host clock, device busy %.1f ms "
          "(%.1f %%), %d kernel launches [%s]"
          % (what, wall_us / 1e3, busy / 1e3, 100 * busy / wall_us,
             len(kernels), card))
    rows = [a for a in prof.key_averages()
            if a.device_type == torch.autograd.DeviceType.CUDA
            and a.key not in profiling.SPANS]
    rows.sort(key=lambda a: a.self_device_time_total, reverse=True)
    print("profiler top ten by device time (ms, calls, name):")
    for a in rows[:10]:
        print("  %10.3f %6d  %s" % (a.self_device_time_total / 1e3, a.count,
                                    a.key[:100]))
    # The port's own kernels (csrc/, each a global in an anonymous
    # namespace; PyTorch's are under at::), in or past the top ten.
    print("profiler, the port's kernels (ms, calls, name):")
    record["port_kernels"] = {}
    for a in rows:
        if a.key.startswith("void (anonymous namespace)::"):
            print("  %10.3f %6d  %s" % (a.self_device_time_total / 1e3,
                                        a.count, a.key[:100]))
            record["port_kernels"][a.key[:80]] = a.count
    return out


def limb_engine_path(pub, priv, dev, card, totals):
    """Phase 7: the limb engine at the fixed 8192-bit key.

    n^2 (16,384 bits) is past the RNS channel supply, so encryption and
    every per-element modexp mod n^2 run on the limb engine (mont_pow_shared
    at L = 1,176, window 5; mont_pow, window 4), while decryption stays on
    the RNS ladders of p^2 and q^2 (k = 624), as phe_tpu runs this key.
    Each step runs through its entry point with the launch counts zeroed
    just before it and read just after, is checked exactly and timed on the
    host clock: encrypt and decrypt of LIMB_ROWS rows, a pinned-r batch of
    4 against the host's raw_encrypt, add at equal exponents, mixed-sign
    mul_scalars, short encrypt, and _decrypt_residue_limb (the limb decrypt
    that runs alone only above ~8,760-bit keys) on LIMB_DIRECT_ROWS rows
    against the RNS decrypt. The encrypt's r^n (mont_pow_shared, 8192-bit
    exponent) is held against its plain version and Python's pow on 2 of
    its LIMB_ROWS rows, since the plain version takes seconds a row; both
    forms are held against their plain versions over LIMB_POW_ROWS rows on
    64-bit exponents.

    Returns ({BENCH_8192.json metric: ops/s}, {kernel: its L = 1,176
    check records}).
    """
    import phe_tpu_torch as pt
    from phe_tpu_torch import batch as tbatch
    from phe_tpu_torch.batch import EncryptedBatch
    from phe_tpu_torch.ops import cuda_modexp
    from phe_tpu_torch.ops import montgomery as mg
    from phe_tpu_torch.utils import limbs as hl

    dc, pdc = pub.device_context(dev), priv.device_context(dev)
    check(dc.rns_state() is None, "8192-bit n^2 was given an RNS state")
    halves = pdc.rns_state()
    check(halves is not None and len(halves) == 2,
          "the 8192-bit key's RNS decrypt halves were not built")
    print("8192-bit key: n^2 on the limb engine (L = %d); decrypt halves on "
          "the RNS ladder (k = %d, %d)" % (dc.L, halves[0][0].k,
                                           halves[1][0].k))
    g = np.random.default_rng(SEED + 8)
    rng = random.Random(SEED + 8)
    rows, nsq = LIMB_ROWS, pub.nsquare
    chunk = EncryptedBatch._INVERSE_CHUNK
    rates = {}

    def floats(lo, hi, count=rows):
        return [float(v) for v in g.uniform(lo, hi, count)]

    def report(step, count, seconds, counts, metric=None):
        if metric:
            rates[metric] = count / seconds
        print("8192-bit %s: %d rows in %.3f s, %.3f rows/s; launches %s [%s]"
              % (step, count, seconds, count / seconds, json.dumps(counts),
                 card))

    xs = floats(-1e6, 1e6)
    # The first encrypt builds and packs the modexp's REDC matrices of n^2
    # inside its span, as every key's first batch does; the second runs
    # without that.
    for step, metric in (("encrypt", "paillier_encrypt_8192_batched"),
                         ("encrypt, second batch", None)):
        enc, sec, n = run_step(
            lambda: EncryptedBatch.encrypt(pub, xs, device=dev), totals)
        # to_mont(r) and the (n*m + 1) prologue: two shared-operand products.
        expect_launches("8192-bit " + step, n, {
            "mont_pow_shared": 1, "mont_mul_const": 2, "mont_mul": 1})
        report(step, rows, sec, n, metric)
    dec, sec, n = run_step(lambda: enc.decrypt(priv), totals)
    expect_launches("8192-bit decrypt", n, {
        "rns_ladder": 2, "mont_mul": 3, "mont_mul_const": 6})
    report("decrypt", rows, sec, n, "paillier_decrypt_8192_batched")
    check(dec == xs, "8192-bit decrypt(encrypt(x)) != x")
    again = profiled("8192-bit %d-row decrypt" % rows,
                     lambda: enc.decrypt(priv), card)
    check(again == xs, "profiled 8192-bit decrypt(encrypt(x)) != x")

    few = xs[:4]
    rs = [rng.randrange(1, pub.n) for _ in few]
    pinned, sec, n = run_step(lambda: EncryptedBatch.encrypt(
        pub, few, r_values=rs, device=dev), totals)
    encs = pt.EncodedNumber.encode_many(pub, few)
    check(pinned.ciphertext_ints(be_secure=False)
          == [pub.raw_encrypt(e.encoding, r_value=r)
              for e, r in zip(encs, rs)],
          "8192-bit pinned-r ciphertexts differ from the host's raw_encrypt")
    report("pinned-r encrypt (ints equal raw_encrypt)", len(few), sec, n)

    same = EncryptedBatch.encrypt(pub, xs, obfuscation="none", device=dev)
    s, sec, n = run_step(lambda: enc + same, totals)
    expect_launches("8192-bit add", n, {"mont_mul": 1})
    report("add, equal exponents", rows, sec, n, "paillier_add_8192_batched")
    check(s.decrypt(priv) == [x + x for x in xs],
          "8192-bit add: decrypt(x + x) != x + x")
    idx = list(range(min(16, rows)))
    c1, c2 = dc.export_ints(enc.mont[idx]), dc.export_ints(same.mont[idx])
    check(dc.export_ints(s.mont[idx]) == [a * b % nsq for a, b in zip(c1, c2)],
          "8192-bit add: ciphertexts differ from the host's c1 c2 mod n^2")

    sc = floats(-100.0, 100.0)
    s, sec, n = run_step(lambda: enc * sc, totals)
    mm, mc = inverse_launches(enc.mont.shape[0], chunk)
    expect_launches("8192-bit mul_scalars", n, {
        "mont_pow": 1, "mont_mul": mm, "mont_mul_const": mc})
    report("mul_scalars, mixed sign", rows, sec, n,
           "paillier_mul_8192_batched")
    check(s.decrypt(priv) == [x * y for x, y in zip(xs, sc)],
          "8192-bit mul_scalars: decrypt(x * s) != x * s")

    short, sec, n = run_step(lambda: EncryptedBatch.encrypt(
        pub, xs, obfuscation="short", device=dev), totals)
    expect_launches("8192-bit short encrypt, first batch", n, {
        "mont_mul_const": 2, "mont_pow_shared": 1, "mont_pow": 1,
        "mont_mul": 1})
    report("short encrypt, first batch", rows, sec, n)
    check(short.decrypt(priv) == xs, "8192-bit short encrypt: decrypt != x")

    head = enc.mont[:LIMB_DIRECT_ROWS].contiguous()
    got, sec, n = run_step(lambda: tbatch._decrypt_residue_limb(
        head, dc.ctx, pdc.consts), totals)
    expect_launches("_decrypt_residue_limb", n, {
        "mont_pow_shared": 2, "mont_mul_const": 8, "mont_mul": 3})
    report("_decrypt_residue_limb (L = %d)" % pdc.consts.ctx_p.num_limbs,
           LIMB_DIRECT_ROWS, sec, n)
    want = [e.encoding for e in pt.EncodedNumber.encode_many(
        pub, xs[:LIMB_DIRECT_ROWS])]
    check(hl.limbs_to_ints(got.cpu().numpy()) == want
          and hl.limbs_to_ints(tbatch._decrypt_residue_rns(
              head, dc.ctx, pdc.consts, *halves).cpu().numpy()) == want,
          "_decrypt_residue_limb differs from the RNS decrypt")
    # Its two mont_pow_shared launches alone, on their own inputs, warm.
    plain = mg.from_mont(head, dc.ctx)
    k = pdc.consts
    for half, ctx2, red, ddig in (("p", k.ctx_p, k.red_p, k.dp_digits),
                                  ("q", k.ctx_q, k.red_q, k.dq_digits)):
        xm = tbatch._mont_entry(mg.mod_reduce(plain, ctx2, red), ctx2)
        ms = cuda_ms(lambda: cuda_modexp.mont_pow_shared(
            xm, ddig, ctx2, window=tbatch.DECRYPT_WINDOW), 1)
        print("_decrypt_residue_limb's mont_pow_shared (%s^2) L=%d windows=%d:"
              " %.3f ms at %d rows, %s [%s]"
              % (half, ctx2.num_limbs, len(ddig), ms, LIMB_DIRECT_ROWS,
                 tile_text(ctx2.num_limbs, LIMB_DIRECT_ROWS), card))

    # The kernels at L = 1,176, as the path runs them.
    ctx, L = dc.ctx, dc.L
    R = 1 << (14 * L)
    R_inv = pow(R, -1, nsq)
    wide = {}
    # The encrypt's own launch: r^n over LIMB_ROWS rows (the first two
    # held against Python's pow), and the same kernel on 2 rows.
    xs2 = [rng.randrange(0, 2 * nsq) for _ in range(rows)]
    base = mg._tensor(hl.ints_to_limbs(xs2, L), dev)
    nd = len(dc.n_digits)
    run = lambda b: cuda_modexp.mont_pow_shared(b, dc.n_digits, ctx, window=5)
    got, ms_rows = cuda_once(lambda: run(base))
    two = base[:2].contiguous()
    got2, ms = cuda_once(lambda: run(two))
    t0 = time.perf_counter()
    want = [pow(x * R_inv, pub.n, nsq) * R % nsq for x in xs2[:2]]
    py_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ref = mg.mont_pow_shared_plain(two, dc.n_digits, ctx, window=5)
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = int((mg.export_canonical(got[:2], ctx)
               - mg.export_canonical(ref, ctx)).abs().max())
    gi = hl.limbs_to_ints(got.cpu().numpy())
    check(err == 0, "mont_pow_shared L=%d: kernel value mod M differs from "
          "the plain version" % L)
    check([v % nsq for v in gi[:2]] == want
          and hl.limbs_to_ints(got2.cpu().numpy()) == gi[:2]
          and int(got.min()) >= 0 and int(got.max()) <= 1 << 14
          and all(100 * v < 101 * nsq for v in gi),
          "mont_pow_shared L=%d: value differs from Python pow" % L)
    products = sum(pow_products(5, nd))
    bms, by = body_pow_bound(launch_body(L, 2), 2, L, 5, nd, 8 * nd)
    bms_rows, by_rows = body_pow_bound(launch_body(L, rows), rows, L, 5, nd,
                                       8 * nd)
    check(ms >= bms and ms_rows >= bms_rows,
          "mont_pow_shared L=%d ran under its bound" % L)
    print("mont_pow_shared L=%d windows=%d: value-equal to the plain "
          "version and Python pow on 2 rows; kernel %.3f ms at %d rows, %s "
          "(bound %.3f ms, %s), %.3f ms at 2 rows, %s (bound %.4f ms, %s), "
          "plain %.1f ms and Python pow %.1f ms for 2, %d products a row "
          "[%s]" % (L, nd, ms_rows, rows, tile_text(L, rows), bms_rows,
                    by_rows, ms, tile_text(L, 2), bms, by, plain_ms, py_ms,
                    products, card))
    wide["mont_pow_shared"] = [dict(
        L=L, rows=rows, body="int8" if launch_body(L, rows) else "int",
        tile=tile_text(L, rows), max_abs_err=err, ms=ms_rows,
        plain_ms=plain_ms, plain_rows=2, bound_ms=bms_rows, bound_by=by_rows,
        ms_at_2_rows=ms, bound_ms_at_2_rows=bms, python_pow_ms=py_ms,
        products=products)]
    del base, got, ref

    rows_p = LIMB_POW_ROWS
    xs3 = [rng.randrange(0, 2 * nsq) for _ in range(rows_p)]
    es = [rng.getrandbits(64) for _ in range(rows_p - 2)] + [0, (1 << 64) - 1]
    base = mg._tensor(hl.ints_to_limbs(xs3, L), dev)
    digits = torch.as_tensor(tbatch._digits_rows(es, 64), device=dev)
    got, ms = cuda_once(lambda: cuda_modexp.mont_pow(base, digits, ctx))
    t0 = time.perf_counter()
    ref = mg.mont_pow_plain(base, digits, ctx)
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = int((mg.export_canonical(got, ctx)
               - mg.export_canonical(ref, ctx)).abs().max())
    gi = hl.limbs_to_ints(got.cpu().numpy())
    check(err == 0 and int(got.min()) >= 0 and int(got.max()) <= 1 << 14
          and all(100 * v < 101 * nsq for v in gi),
          "mont_pow L=%d: kernel value mod M differs from the plain version"
          % L)
    for i in (0, 1, rows_p - 2, rows_p - 1):
        check(gi[i] % nsq == pow(xs3[i] * R_inv, es[i], nsq) * R % nsq,
              "mont_pow L=%d: value differs from Python pow" % L)
    n_windows = digits.shape[1]
    products = sum(pow_products(4, n_windows))
    bms, by = body_pow_bound(launch_body(L, rows_p), rows_p, L, 4,
                             n_windows, rows_p * n_windows)
    check(ms >= bms, "mont_pow L=%d ran under its bound" % L)
    print("mont_pow L=%d windows=%d: value-equal on %d rows, Python pow on "
          "4; kernel %.3f ms, %s, plain %.3f ms, bound %.4f ms (%s, %d "
          "products a row)" % (L, n_windows, rows_p, ms, tile_text(L, rows_p),
                               plain_ms, bms, by, products))
    wide["mont_pow"] = [dict(L=L, rows=rows_p, body="int8" if launch_body(
                                 L, rows_p) else "int",
                             tile=tile_text(L, rows_p),
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             plain_rows=rows_p, bound_ms=bms, bound_by=by,
                             products=products)]

    # The shared form at the same shape: one random 64-bit exponent.
    e = rng.getrandbits(64) | 1 << 63
    sdig = torch.as_tensor(mg.exponent_digits(e, 64, 4), device=dev)
    got, ms = cuda_once(lambda: cuda_modexp.mont_pow_shared(base, sdig, ctx,
                                                            window=4))
    t0 = time.perf_counter()
    ref = mg.mont_pow_shared_plain(base, sdig, ctx, window=4)
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = int((mg.export_canonical(got, ctx)
               - mg.export_canonical(ref, ctx)).abs().max())
    gi = hl.limbs_to_ints(got.cpu().numpy())
    check(err == 0 and int(got.min()) >= 0 and int(got.max()) <= 1 << 14
          and all(100 * v < 101 * nsq for v in gi),
          "mont_pow_shared L=%d: kernel value mod M differs from the plain "
          "version on %d rows" % (L, rows_p))
    for i in (0, 1, rows_p - 2, rows_p - 1):
        check(gi[i] % nsq == pow(xs3[i] * R_inv, e, nsq) * R % nsq,
              "mont_pow_shared L=%d: value differs from Python pow" % L)
    n_windows = len(sdig)
    products = sum(pow_products(4, n_windows))
    bms, by = body_pow_bound(launch_body(L, rows_p), rows_p, L, 4,
                             n_windows, 8 * n_windows)
    check(ms >= bms, "mont_pow_shared L=%d ran under its bound" % L)
    print("mont_pow_shared L=%d windows=%d: value-equal on %d rows, Python "
          "pow on 4; kernel %.3f ms, %s, plain %.3f ms, bound %.4f ms (%s, "
          "%d products a row)" % (L, n_windows, rows_p, ms,
                                  tile_text(L, rows_p), plain_ms, bms, by,
                                  products))
    wide["mont_pow_shared"].append(dict(
        L=L, rows=rows_p, body="int8" if launch_body(L, rows_p) else "int",
        tile=tile_text(L, rows_p), max_abs_err=err, ms=ms, plain_ms=plain_ms,
        plain_rows=rows_p, bound_ms=bms, bound_by=by, products=products))
    print(json.dumps({"paillier_8192": {
        m: {"value": v, "unit": "ops/s", "batch": rows}
        for m, v in rates.items()}, "card": card}))
    return rates, wide


def body_sweep(dev, card):
    """Phase 7's two-body sweep: each limb launch of the sweep's shapes
    timed in both REDC bodies, the int8 one and the integer pipe, in
    turns (int8, int, int, int8), each turn the CUDA-event mean over
    enough launches to fill SWEEP_MS, after the two bodies' outputs are
    found equal mod M; printed beside the body that
    cuda_modexp._body picks there, and checked for the modexps, which the
    rule follows: the rule's body is never slower in both of its turns
    than the other in either, by more than 5 %. (A product follows its
    modexp: at L <= 152 the integer pipe runs it faster, and the sweep
    shows by how much.) Returns the rows of the record: (form, L, B,
    int8 ms, int ms, the rule's body)."""
    from phe_tpu_torch import batch as tbatch
    from phe_tpu_torch import benchmarks
    from phe_tpu_torch.ops import cuda_modexp, cuda_rns
    from phe_tpu_torch.ops import montgomery as mg

    sms = cuda_rns._sms(dev)
    moduli = {}
    for bits in SWEEP_KEYS:
        pub, priv = benchmarks.fixed_key(bits)
        for M in (pub.nsquare, priv.psquare, priv.p):
            moduli.setdefault(mg.num_limbs_for_modulus(M.bit_length()), M)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 22)
    rng = random.Random(SEED + 22)
    rows_out, wrong = [], []

    def operand(M, L, B):
        """[B, L] limbs of values below M: random limbs under M's top."""
        x = torch.randint(0, 1 << 14, (B, L), generator=gen, device=dev,
                          dtype=torch.int64)
        x[:, (M.bit_length() - 1) // 14:] = 0
        return x

    def turns(fn, ctx):
        """{body: [ms, ms]} of fn(body) in turns int8, int, int, int8,
        after both bodies' outputs are found equal mod M."""
        outs = [mg.export_canonical(fn(body), ctx) for body in (True, False)]
        check(torch.equal(*outs), "the two REDC bodies' outputs differ mod M")
        del outs
        reps = {b: max(1, min(200, int(SWEEP_MS / max(cuda_once(
            lambda: fn(b))[1], 1e-3)))) for b in (True, False)}
        out = {True: [], False: []}
        for body in (True, False, False, True):
            out[body].append(cuda_ms(lambda: fn(body), reps[body],
                                     warm=False))
        return out

    def report(form, L, B, ms, extra=""):
        rule = cuda_modexp._body(L, B, sms)
        best = min(ms[rule])
        other = min(ms[not rule])
        name = {True: "int8", False: "int"}
        print("sweep %s L=%d B=%d%s: int8 %.4f / %.4f ms (%s), int %.4f / "
              "%.4f ms (%s); rule: %s, %.3f of the other [%s]"
              % (form, L, B, extra, ms[True][0], ms[True][1],
                 tile_text(L, B, True, "mont_pow" if "pow" in form
                           else "mont_mul"), ms[False][0], ms[False][1],
                 tile_text(L, B, False, "mont_pow" if "pow" in form
                           else "mont_mul"), name[rule], best / other, card))
        rows_out.append((form, L, B, ms[True], ms[False], name[rule]))
        if "pow" in form and min(ms[rule]) > 1.05 * max(ms[not rule]):
            wrong.append("%s at L = %d, B = %d" % (form, L, B))

    for L, M in sorted(moduli.items()):
        ctx = mg.build_context(M, dev)
        for B in SWEEP_ROWS:
            a, b = operand(M, L, B), operand(M, L, B)
            for shared in (False, True):
                ms = turns(lambda body: cuda_modexp._launch(
                    a, b[0] if shared else b, ctx, shared, body), ctx)
                report("mont_mul_const" if shared else "mont_mul", L, B, ms)
            del a, b
        e = rng.getrandbits(SWEEP_BITS) | 1 << (SWEEP_BITS - 1)
        sdig = torch.as_tensor(mg.exponent_digits(e, SWEEP_BITS), device=dev)
        for B in SWEEP_POW_ROWS:
            x = operand(M, L, B)
            vdig = torch.as_tensor(tbatch._digits_rows(
                [rng.getrandbits(SWEEP_BITS) for _ in range(B)],
                SWEEP_BITS), device=dev)
            for vec, d in ((False, sdig), (True, vdig)):
                ms = turns(lambda body: cuda_modexp._pow_launch(
                    x, d, ctx, mg.DEFAULT_WINDOW, vec, body), ctx)
                report("mont_pow" if vec else "mont_pow_shared", L, B, ms,
                       " (%d-bit exponents)" % SWEEP_BITS)
            del x, vdig
        torch.cuda.empty_cache()
    # The 8192-bit encrypt's own launch: r^n over LIMB_ROWS rows at
    # L = 1,176, window 5.
    pub8 = benchmarks.fixed_key(8192)[0]
    ctx = mg.build_context(pub8.nsquare, dev)
    L = ctx.num_limbs
    ndig = torch.as_tensor(mg.exponent_digits(
        pub8.n, pub8.n.bit_length(), tbatch.ENCRYPT_WINDOW), device=dev)
    x = operand(pub8.nsquare, L, LIMB_ROWS)
    ms = turns(lambda body: cuda_modexp._pow_launch(
        x, ndig, ctx, tbatch.ENCRYPT_WINDOW, False, body), ctx)
    report("mont_pow_shared", L, LIMB_ROWS, ms, " (r^n, exponent n)")
    print(json.dumps({"body_sweep": rows_out, "card": card}))
    check(not wrong, "the body rule picks the body slower in both turns by "
          "more than 5 %% for %s" % "; ".join(wrong))
    return rows_out


def wire_path(pub, priv, dev, card, totals):
    """Phase 8, the wire formats, the CLI, the CRT powers and the mesh at
    the fixed 2048-bit key over BATCH rows, each step with its launches.
    Returns (step seconds, the mont_pow_shared check at L = 152)."""
    import os
    import socket
    import subprocess
    import tempfile
    from fractions import Fraction

    import torch.distributed as dist
    from click.testing import CliRunner

    from phe_tpu_torch import batch as tbatch
    from phe_tpu_torch import native, parallel, serial
    from phe_tpu_torch.batch import EncryptedBatch
    from phe_tpu_torch.cli import cli
    from phe_tpu_torch.models import (
        FederatedClient,
        aggregate_encrypted_gradients,
    )
    from phe_tpu_torch.ops import cuda_modexp
    from phe_tpu_torch.ops import montgomery as mg
    from phe_tpu_torch.utils import limbs as hl
    from phe_tpu_torch.utils import ntheory

    g = np.random.default_rng(SEED + 8)
    rng = random.Random(SEED + 8)
    xs = [float(v) for v in g.uniform(-1e6, 1e6, BATCH)]
    seconds, counts = {}, {}

    def step(name, fn, want):
        out, sec, n = run_step(fn, totals)
        if want is not None:
            expect_launches(name, n, want)
        seconds[name], counts[name] = sec, n
        print("  %s: %.4f s; launches %s" % (name, sec, json.dumps(n)))
        return out

    encrypt_n = {"mont_mul": 1, "mont_mul_const": 1, "rns_ladder": 1}
    secure_n = {"rns_ladder": 1, "mont_mul": 1, "mont_mul_const": 1}
    decrypt_n = {"mont_mul": 3, "mont_mul_const": 6, "rns_ladder": 2}

    # -- the vector wire format, BATCH rows, each step apart --------------
    print("wire format, %d rows [%s]:" % (BATCH, card))
    batch = step("encrypt", lambda: EncryptedBatch.encrypt(pub, xs,
                                                           device=dev),
                 encrypt_n)
    data = step("dump_encrypted_batch, secure", lambda:
                serial.dump_encrypted_batch(batch),
                dict(secure_n, rns_ladder_vec=1))
    text = step("json.dumps", lambda: json.dumps(data), {})
    parsed = step("json.loads", lambda: json.loads(text), {})
    back = step("load_encrypted_batch", lambda: serial.load_encrypted_batch(
        parsed, pub), {"mont_mul_const": 1})
    check(back.mont.is_cuda, "load_encrypted_batch did not load onto the card")
    out = step("decrypt", lambda: back.decrypt(priv), decrypt_n)
    check(out == xs, "wire round trip: decrypt(load(dump(encrypt(x)))) != x "
          "for %d of %d rows" % (sum(a != b for a, b in zip(out, xs)), BATCH))
    # The dump's three parts apart, on the same batch.
    target = [min(int(e), serial.SERIALISED_EXPONENT) for e in batch.exponents]
    pinned = step("  its pin to -32", lambda: batch.decrease_exponent_to(
        target), {"rns_ladder_vec": 1})
    ints = step("  its secure export", lambda: pinned.ciphertext_ints(),
                secure_n)
    step("  its decimal strings", lambda: [serial.int_to_decimal(c)
                                           for c in ints], {})
    host = ("json.dumps", "json.loads", "  its decimal strings")
    wire = ("dump_encrypted_batch, secure", "json.dumps", "json.loads",
            "load_encrypted_batch")
    print("wire format: %d bytes of JSON for %d ciphertexts; dump %.1f rows/s, "
          "load %.1f rows/s, dump + json + load %.1f rows/s; decimal and json "
          "(host only) %.4f of %.4f s [%s]"
          % (len(text), BATCH, BATCH / seconds[wire[0]],
             BATCH / seconds[wire[3]],
             BATCH / sum(seconds[k] for k in wire),
             sum(seconds[k] for k in host), sum(seconds[k] for k in wire),
             card))
    del data, text, parsed, back, pinned, ints

    # Pinned r is not obfuscated: the dump is raw_encrypt's, JSON for JSON.
    few = xs[:WIRE_FEW]
    rs = [rng.randrange(1, pub.n) for _ in few]
    got = serial.dump_encrypted_batch(
        EncryptedBatch.encrypt(pub, few, r_values=rs, device=dev),
        be_secure=False)
    want = []
    for x, r in zip(few, rs):
        enc = pub.encrypt(x, r_value=r)
        if enc.exponent > serial.SERIALISED_EXPONENT:
            enc = enc.decrease_exponent_to(serial.SERIALISED_EXPONENT)
        want.append({"v": str(enc.ciphertext(be_secure=False)),
                     "e": enc.exponent})
    check(json.dumps(got) == json.dumps({"values": want}),
          "pinned-r dump differs from the host's raw_encrypt")
    print("pinned-r batch of %d: its dump equals raw_encrypt's, JSON for JSON"
          % len(few))

    # -- the CLI in this process, on JWK files of the key ------------------
    repo = os.path.dirname(os.path.abspath(__file__))
    ps = [float(v) for v in g.uniform(-1e3, 1e3, BATCH)]
    inverse_mm, inverse_mc = inverse_launches(BATCH,
                                              EncryptedBatch._INVERSE_CHUNK)
    with tempfile.TemporaryDirectory() as tmp:
        f = lambda name: os.path.join(tmp, name)
        for name, obj in (
                ("priv.json", serial.private_key_to_jwk(priv, kid="smoke")),
                ("pub.json", serial.public_key_to_jwk(pub, kid="smoke")),
                ("x.json", xs), ("p.json", ps), ("few.json", xs[:CLI_FEW])):
            with open(f(name), "w") as fh:
                json.dump(obj, fh)
        # What each command pays for the key's device constants: it loads
        # the key from its file, and a new key builds them anew.
        with open(f("priv.json")) as fh:
            key = serial.private_key_from_jwk(json.load(fh))
        t0 = time.perf_counter()
        kdc, kpdc = key.public_key.device_context(dev), key.device_context(dev)
        kdc.rns_state()
        kpdc.rns_state()
        t_consts = time.perf_counter() - t0
        t_redc = redc_seconds(key_contexts(kdc, kpdc))
        print("pheutil: key constants %.3f s, REDC matrices of the five "
              "contexts %.3f s, paid by every vector command [%s]"
              % (t_consts, t_redc, card))
        runner = CliRunner()

        def pheutil(*args, want=None):
            res = step("pheutil " + args[0], lambda: runner.invoke(
                cli, [str(a) for a in args]), want)
            check(res.exit_code == 0, "pheutil %s failed: %r\n%s"
                  % (args[0], res.exception, res.output[-2000:]))
            return res.stdout

        def decryptvec(name):
            out = pheutil("decryptvec", f("priv.json"), f(name),
                          want={"mont_mul": 3, "mont_mul_const": 7,
                                "rns_ladder": 2})
            return json.loads(out.strip().splitlines()[-1])

        print("pheutil in this process, %d values [%s]:" % (BATCH, card))
        pheutil("encryptvec", "--output", f("e.json"), f("pub.json"),
                f("x.json"), want={"mont_mul": 2, "mont_mul_const": 2,
                                   "rns_ladder": 2, "rns_ladder_vec": 1})
        check(decryptvec("e.json") == xs, "pheutil encryptvec / decryptvec: "
              "not x")
        pheutil("addvec", "--output", f("a.json"), f("pub.json"),
                f("e.json"), f("p.json"),
                want={"mont_mul": 2, "mont_mul_const": 3, "rns_ladder": 1})
        check(decryptvec("a.json") == [x + p for x, p in zip(xs, ps)],
              "pheutil addvec: not the exactly rounded x + p")
        pheutil("multiplyvec", "--output", f("m.json"), f("pub.json"),
                f("e.json"), f("p.json"),
                want={"mont_mul": inverse_mm + 1,
                      "mont_mul_const": inverse_mc + 2, "rns_ladder": 1,
                      "rns_ladder_vec": 1})
        check(decryptvec("m.json") == [x * p for x, p in zip(xs, ps)],
              "pheutil multiplyvec: not the exactly rounded x p")
        pheutil("addencvec", "--output", f("d.json"), f("pub.json"),
                f("a.json"), f("e.json"),
                want={"mont_mul": 2, "mont_mul_const": 3, "rns_ladder": 1})
        check(decryptvec("d.json") == [
            float(2 * Fraction(x) + Fraction(p)) for x, p in zip(xs, ps)],
            "pheutil addencvec: not the exactly rounded 2x + p")
        pheutil("sumvec", "--output", f("s.json"), f("pub.json"),
                f("e.json"), want={"mont_mul": tree_depth(BATCH),
                                   "mont_mul_const": 2})
        with open(f("s.json")) as fh:
            total = priv.decrypt(serial.load_encrypted_number(json.load(fh),
                                                              pub))
        check(total == float(sum(map(Fraction, xs))),
              "pheutil sumvec: not the exactly rounded sum")
        # A process of its own, as a user runs it.
        for name, args in (
                ("encryptvec", ["--output", f("fe.json"), f("pub.json"),
                                f("few.json")]),
                ("decryptvec", [f("priv.json"), f("fe.json")])):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "phe_tpu_torch.cli", name] + args,
                capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
                cwd=repo)
            seconds["python -m phe_tpu_torch.cli " + name] = (
                time.perf_counter() - t0)
            check(proc.returncode == 0, "python -m phe_tpu_torch.cli %s "
                  "failed:\n%s" % (name, proc.stderr[-2000:]))
        check(json.loads(proc.stdout.strip().splitlines()[-1])
              == xs[:CLI_FEW], "pheutil in its own process: not x")
        print("python -m phe_tpu_torch.cli encryptvec, decryptvec of %d "
              "values, each a process of its own: %.2f s, %.2f s [%s]"
              % (CLI_FEW, seconds["python -m phe_tpu_torch.cli encryptvec"],
                 seconds["python -m phe_tpu_torch.cli decryptvec"], card))

    # -- the CRT powers: mont_pow_shared at L = 152 over BATCH rows --------
    pdc = priv.device_context(dev)
    c = pdc.consts
    (xp, xq), sec, n = run_step(lambda: pdc.crt_powers(batch.mont), totals)
    expect_launches("crt_powers", n, {"mont_mul_const": 5,
                                      "mont_pow_shared": 2})
    seconds["crt_powers"] = sec
    cts = batch.ciphertext_ints(be_secure=False)
    idx = sorted(rng.sample(range(BATCH), CRT_SAMPLE))
    for got, d in ((xp, priv.p), (xq, priv.q)):
        vals = hl.limbs_to_ints(got[idx].cpu().numpy())
        check(vals == [pow(cts[i], d - 1, d * d) for i in idx],
              "crt_powers differs from Python's pow")
    ctx2, digits = c.ctx_p, c.dp_digits
    L2 = ctx2.num_limbs
    xm = tbatch._mont_entry(mg.mod_reduce(
        mg.from_mont(batch.mont, pub.device_context(dev).ctx), ctx2,
        c.red_p), ctx2)
    run = lambda b: cuda_modexp.mont_pow_shared(b, digits, ctx2,
                                                window=tbatch.DECRYPT_WINDOW)
    got = run(xm)
    head = xm[:CRT_PLAIN_ROWS].contiguous()
    sync()
    t0 = time.perf_counter()
    ref = mg.mont_pow_shared_plain(head, digits, ctx2,
                                   window=tbatch.DECRYPT_WINDOW)
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = int((mg.export_canonical(got[:CRT_PLAIN_ROWS], ctx2)
               - mg.export_canonical(ref, ctx2)).abs().max())
    check(err == 0, "mont_pow_shared L=%d: kernel value mod M differs from "
          "the plain version" % L2)
    ms = cuda_ms(lambda: run(xm), 3)
    windows = len(digits)
    bms, by = body_pow_bound(launch_body(L2, BATCH), BATCH, L2,
                             tbatch.DECRYPT_WINDOW, windows, 8 * windows)
    check(ms >= bms, "mont_pow_shared L=%d ran under its bound" % L2)
    print("crt_powers: %d rows in %.4f s, %.1f rows/s, Python pow on %d "
          "sampled rows of both halves; launches %s; mont_pow_shared L=%d "
          "windows=%d (%s): kernel %.3f ms, value-equal to its plain version "
          "on %d rows (%.3f ms), bound %.3f ms (%s) [%s]"
          % (BATCH, sec, BATCH / sec, CRT_SAMPLE, json.dumps(n), L2, windows,
             tile_text(L2, BATCH), ms, CRT_PLAIN_ROWS, plain_ms, bms, by,
             card))
    crt_check = dict(L=L2, rows=BATCH, tile=tile_text(L2, BATCH),
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     plain_rows=CRT_PLAIN_ROWS, bound_ms=bms, bound_by=by,
                     products=sum(pow_products(tbatch.DECRYPT_WINDOW,
                                               windows)))
    del xp, xq, xm, got, ref, head

    # -- the native host engine --------------------------------------------
    check(native.HAVE_NATIVE and ntheory.HAVE_NATIVE,
          "the native host engine did not build: HAVE_NATIVE is False")
    a, b = rng.randrange(pub.n), rng.getrandbits(2048)
    t0 = time.perf_counter()
    got = native.powmod(a, b, pub.n)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = pow(a, b, pub.n)
    t_pow = time.perf_counter() - t0
    check(got == want and ntheory.powmod(a, b, pub.n) == want,
          "native powmod differs from Python's pow at 2048 bits")
    print("native host engine: built (HAVE_NATIVE), powmod at 2048 bits "
          "equals pow: %.6f s against pow's %.6f s" % (t_native, t_pow))

    # -- the mesh: a world of one on NCCL ---------------------------------
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    parallel.initialize_distributed("tcp://localhost:%d" % port, 1, 0)
    try:
        check(dist.get_backend() == "nccl", "the process group is not NCCL")
        mesh = parallel.batch_mesh()
        print("mesh: a world of one on NCCL (dp = %d, mp = %d) [%s]:"
              % (mesh.dp, mesh.mp, card))
        sum_n = {"rns_ladder_vec": 1, "mont_mul": tree_depth(BATCH)}
        total = step("encrypted_sum_sharded", lambda:
                     parallel.encrypted_sum_sharded(batch, mesh), sum_n)
        ref = step("batch.sum", lambda: batch.sum(), sum_n)
        check(total.ciphertext_ints(False) == ref.ciphertext_ints(False)
              and list(total.exponents) == list(ref.exponents),
              "encrypted_sum_sharded differs from batch.sum()")
        clients = [FederatedClient("client%d" % i, g.normal(size=(4, BATCH)),
                                   g.normal(size=4) * 10.0 ** (3 * i - 6),
                                   pub, device=dev)
                   for i in range(FL_CLIENTS)]
        encrypted = [cl.encrypted_gradient() for cl in clients]
        meshed = step("FL aggregation over the mesh", lambda:
                      aggregate_encrypted_gradients(encrypted, mesh=mesh),
                      None)
        plain_fl = step("FL aggregation", lambda:
                        aggregate_encrypted_gradients(encrypted), None)
        for name in ("FL aggregation over the mesh", "FL aggregation"):
            n = counts[name]
            check(n.get("mont_mul") == tree_depth(FL_CLIENTS)
                  and 1 <= n.get("rns_ladder_vec", 0) <= FL_CLIENTS
                  and set(n) == {"mont_mul", "rns_ladder_vec"},
                  "%s launched %s" % (name, json.dumps(n)))
        check(meshed.ciphertext_ints(False) == plain_fl.ciphertext_ints(False)
              and list(meshed.exponents) == list(plain_fl.exponents),
              "FL aggregation with the mesh differs from it without")
    finally:
        dist.destroy_process_group()
    print("mesh: encrypted_sum_sharded equals batch.sum() and the FL "
          "aggregation with the mesh equals it without, ciphertext for "
          "ciphertext")
    return seconds, crt_check


def program_cases(pub, priv, dev, rows, names):
    """{name: (program, arguments)} for the batch programs `names` at this
    key over `rows` rows, from seeded values encrypted through the entry
    points; _mul_mont_dev at 32 x rows (bench.py's add batch at 16,384)."""
    import phe_tpu_torch as pt
    from phe_tpu_torch import batch as tbatch
    from phe_tpu_torch import config
    from phe_tpu_torch.batch import EncryptedBatch

    dc, pdc = pub.device_context(dev), priv.device_context(dev)
    ctx, st, halves = dc.ctx, dc.rns_state(), tuple(pdc.rns_state())
    g = np.random.default_rng(SEED + 9)
    xs = [float(v) for v in g.uniform(-1e6, 1e6, rows)]
    ys = [float(v) for v in g.uniform(-1e-3, 1e-3, rows)]
    a = EncryptedBatch.encrypt(pub, xs, device=dev)
    b = EncryptedBatch.encrypt(pub, ys, device=dev)
    m = dc.pack_messages([e.encoding for e in
                          pt.EncodedNumber.encode_many(pub, ys)])
    r = dc.random_r_bytes(rows)

    def digits(bits, count=rows):
        es = [int.from_bytes(g.bytes(-(-bits // 8)), "little")
              % (1 << bits) for _ in range(count)]
        return tbatch._digits_on(tbatch._digits_rows(es, bits), dev)

    short, align = digits(SHORT_BITS), digits(13)
    neg = config.to_device(g.integers(0, 2, rows) != 0, dev)
    inv = a.inverse_mont()
    D = LR_FEATURES + 1
    grid = digits(64, LR_EXAMPLES * D).reshape(LR_EXAMPLES, D, -1)
    neg_grid = config.to_device(g.integers(0, 2, (LR_EXAMPLES, D)) != 0, dev)
    chunk = a.mont[: EncryptedBatch._INVERSE_CHUNK]
    dec = (a.mont, ctx, pdc.consts) + halves
    nr2, nd, Ln = dc.nr2_limbs, dc.n_digits, dc.Ln
    builders = {
        "_encrypt_rns_dev": lambda: (m, r, nr2, nd, ctx, st, Ln),
        "_encrypt_dev": lambda: (m, r, nr2, nd, ctx, Ln),
        "_obfuscate_rns_dev": lambda: (a.mont, r, nd, ctx, st),
        "_decrypt_rns_dev": lambda: dec,
        "_decrypt_compact_rns_dev": lambda: dec,
        "_decrypt_compact_dev": lambda: (a.mont[:LIMB_DIRECT_ROWS], ctx,
                                         pdc.consts),
        "_export_dev": lambda: (a.mont, ctx),
        "_pack_mont_dev": lambda: (b.mont, ctx),
        "_nude_encrypt_dev": lambda: (m, nr2, ctx, Ln),
        "_add_encoded_dev": lambda: (a.mont, m, nr2, ctx, Ln),
        "_mul_mont_dev": lambda: (a.mont.repeat(32, 1), b.mont.repeat(32, 1),
                                  ctx),
        "_add_encrypted_aligned_dev": lambda: (a.mont, align, b.mont, align,
                                               ctx, st),
        "_add_scalars_aligned_dev": lambda: (a.mont, align, m, nr2, ctx, st,
                                             Ln),
        "_pow_elems_dev": lambda: (a.mont, short, ctx, st),
        "_pow_select_dev": lambda: (a.mont, inv, neg, short, ctx, st),
        "_sum_aligned_dev": lambda: (a.mont, align, ctx, st),
        "_tree_reduce_dev": lambda: (a.mont, ctx),
        "_tree_reduce_masked_dev": lambda: (a.mont, neg, ctx),
        "_inverse_scan_dev": lambda: (chunk, ctx),
        "_finish_inverse_dev": lambda: (
            tbatch._inverse_scan(chunk, ctx)[0], a.mont[1], ctx),
        "_matvec_dev": lambda: (a.mont[:D], inv[:D], neg_grid, grid, ctx),
        "_crt_powers_dev": lambda: (a.mont, ctx, pdc.consts),
        "_short_base_dev": lambda: (a.mont[:1], nd, ctx),
        "_obfuscate_short_dev": lambda: (a.mont, a.mont[0], short, ctx),
    }
    return {name: (getattr(tbatch, name), builders[name]()) for name in names}


def check_program(label, prog, args, card):
    """The program bit-equal to its eager body on the card: the body once,
    then the program three times (at a key new here: its warm-up, its
    capture and replay, a replay), each on the host clock; returns its
    record."""
    def outs(x):
        return x if isinstance(x, tuple) else (x,)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, 1e3 * (time.perf_counter() - t0)

    reset_launches()
    eager, eager_ms = timed(lambda: outs(prog.fn(*args)))
    eager_n = read_launches()
    calls = []
    for _ in range(3):
        reset_launches()
        calls.append(timed(lambda: outs(prog(*args))) + (read_launches(),))
    (got, first_ms, _), (second, second_ms, _), (again, replay_ms,
                                                 replay_n) = calls
    check(len(got) == len(second) == len(again) == len(eager)
          and all(torch.equal(x, y) and torch.equal(z, y)
                  and torch.equal(w, y)
                  for x, w, z, y in zip(got, second, again, eager)),
          "%s: the program differs from its eager body" % label)
    check(all(n == eager_n for _, _, n in calls),
          "%s: a call counted %s, the body %s"
          % (label, json.dumps([n for _, _, n in calls]),
             json.dumps(eager_n)))
    print("  %s: bit-equal; eager %.3f ms, the program's calls %.3f, %.3f, "
          "%.3f ms; launches a call %s; graphs captured %d [%s]"
          % (label, eager_ms, first_ms, second_ms, replay_ms,
             json.dumps(replay_n), prog.captured, card))
    return dict(eager_ms=eager_ms, first_ms=first_ms, second_ms=second_ms,
                replay_ms=replay_ms, launches=replay_n,
                graphs=prog.captured)


def programs_phase(keys, dev, card):
    """Phase 9: the batch programs (phe_tpu_torch.programs) against their
    eager bodies at the 2048-, 3072- and 8192-bit keys; the 2048-bit round
    trip under set_sync_debug_mode("error"); a second encrypt leaving the
    first batch's limbs as they were; the 2048-bit round trip and the
    8192-bit decrypt profiled eagerly and through the programs, in turns
    (eager, programs, programs, eager); the memory the card holds and the
    evictions. Returns the phase's record."""
    import phe_tpu_torch as pt
    from phe_tpu_torch import batch as tbatch
    from phe_tpu_torch import programs
    from phe_tpu_torch.batch import EncryptedBatch
    from phe_tpu_torch.programs import DeviceProgram

    (pub, priv), (pub3, priv3), (pub8, priv8) = keys
    record = {"programs": {}}
    rns_names = ["_encrypt_rns_dev", "_obfuscate_rns_dev", "_decrypt_rns_dev",
                 "_decrypt_compact_rns_dev", "_export_dev", "_pack_mont_dev",
                 "_nude_encrypt_dev", "_add_encoded_dev", "_mul_mont_dev",
                 "_add_encrypted_aligned_dev", "_add_scalars_aligned_dev",
                 "_pow_elems_dev", "_pow_select_dev", "_sum_aligned_dev",
                 "_tree_reduce_dev", "_tree_reduce_masked_dev",
                 "_inverse_scan_dev", "_finish_inverse_dev", "_matvec_dev",
                 "_crt_powers_dev", "_short_base_dev", "_obfuscate_short_dev"]
    plans = [
        (pub, priv, BATCH, rns_names),
        (pub3, priv3, BATCH,
         ["_encrypt_rns_dev", "_decrypt_compact_rns_dev", "_export_dev",
          "_mul_mont_dev"]),
        (pub8, priv8, LIMB_ROWS,
         ["_encrypt_dev", "_decrypt_compact_rns_dev", "_decrypt_compact_dev",
          "_export_dev", "_pack_mont_dev", "_nude_encrypt_dev",
          "_mul_mont_dev", "_pow_elems_dev", "_pow_select_dev",
          "_inverse_scan_dev", "_finish_inverse_dev", "_short_base_dev",
          "_obfuscate_short_dev"]),
    ]
    for pk, sk, rows, names in plans:
        bits = pk.n.bit_length()
        print("programs at the %d-bit key, %d rows [%s]:" % (bits, rows,
                                                             card))
        for name, (prog, args) in program_cases(pk, sk, dev, rows,
                                                names).items():
            label = "%d-bit %s" % (bits, name)
            record["programs"][label] = check_program(label, prog, args,
                                                      card)
        del prog, args

    # No host wait from the upload to the last program of a round trip.
    g = np.random.default_rng(SEED + 10)
    xs = [float(v) for v in g.uniform(-1e6, 1e6, BATCH)]
    for _ in range(2):  # the keys' warm-ups and captures
        check(EncryptedBatch.encrypt(pub, xs, device=dev).decrypt(priv)
              == xs, "round trip before the sync check: decrypt(encrypt(x)) "
              "!= x")
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        finish = EncryptedBatch.encrypt(pub, xs, device=dev).decrypt_async(
            priv)
    except RuntimeError as e:
        fail("the 2048-bit round trip waited on the host: %s" % e)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(finish() == xs, "round trip under the sync check: "
          "decrypt(encrypt(x)) != x")
    print("2048-bit %d-row round trip, upload to decrypt's device half, "
          "under set_sync_debug_mode(\"error\"): no host wait" % BATCH)

    # No replay overwrites a batch that is still held.
    ys = [-v for v in xs]
    first = EncryptedBatch.encrypt(pub, xs, device=dev)
    snap = first.mont.clone()
    second = EncryptedBatch.encrypt(pub, ys, device=dev)
    sync()
    check(torch.equal(first.mont, snap)
          and first.mont.data_ptr() != second.mont.data_ptr(),
          "a second encrypt overwrote the first batch's limbs")
    check(first.decrypt(priv) == xs and second.decrypt(priv) == ys,
          "two encrypts through one graph: decrypt != x")
    print("a second %d-row encrypt leaves the first batch's limbs as they "
          "were" % BATCH)
    del first, second, snap

    # Profiles, eagerly (the bodies) and through the programs, in turns.
    dc, pdc = pub.device_context(dev), priv.device_context(dev)

    def eager_round_trip():
        encs = pt.EncodedNumber.encode_many(pub, xs)
        mont = tbatch._encrypt_rns(
            dc.pack_messages([e.encoding for e in encs]),
            dc.random_r_bytes(len(xs)), dc.nr2_limbs, dc.n_digits, dc.ctx,
            dc.rns_state(), dc.Ln)
        batch = EncryptedBatch(pub, mont, [e.exponent for e in encs], True)
        compact, full = tbatch._decrypt_compact_rns(
            mont, dc.ctx, pdc.consts, *pdc.rns_state())
        return batch._finish_decrypt_fast(compact, full, pt.EncodedNumber)

    x8 = [float(v) for v in g.uniform(-1e6, 1e6, LIMB_ROWS)]
    enc8 = EncryptedBatch.encrypt(pub8, x8, device=dev)
    dc8, pdc8 = pub8.device_context(dev), priv8.device_context(dev)

    def eager_decrypt8():
        compact, full = tbatch._decrypt_compact_rns(
            enc8.mont, dc8.ctx, pdc8.consts, *pdc8.rns_state())
        return enc8._finish_decrypt_fast(compact, full, pt.EncodedNumber)

    turns = [
        ("2048-bit %d-row round trip" % BATCH, xs, eager_round_trip,
         lambda: EncryptedBatch.encrypt(pub, xs, device=dev).decrypt(priv)),
        ("8192-bit %d-row decrypt" % LIMB_ROWS, x8, eager_decrypt8,
         lambda: enc8.decrypt(priv8)),
    ]
    for what, want, eager, program in turns:
        for i, (how, fn) in enumerate((("eager", eager),
                                       ("programs", program),
                                       ("programs", program),
                                       ("eager", eager))):
            label = "%s, %s (turn %d)" % (what, how, i + 1)
            check(profiled(label, fn, card) == want,
                  "%s: decrypt != x" % label)
            record.setdefault("profiles", {})[label] = PROFILES[label]

    graphs = {name: p.captured for name, p in vars(tbatch).items()
              if isinstance(p, DeviceProgram) and p.captured}
    record["graphs"] = graphs
    record["evictions"] = programs.evictions
    record["memory_reserved"] = torch.cuda.memory_reserved(dev)
    record["memory_allocated"] = torch.cuda.memory_allocated(dev)
    print("programs: %d graphs captured over %d programs, %d evictions "
          "since the start; memory reserved %.2f GiB, allocated %.2f GiB "
          "[%s]" % (sum(graphs.values()), len(graphs), programs.evictions,
                    record["memory_reserved"] / 2**30,
                    record["memory_allocated"] / 2**30, card))
    return record


def main():
    started = time.time()
    parent = None
    if "--parent" in sys.argv:
        parent = sys.argv[sys.argv.index("--parent") + 1]
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import phe_tpu_torch as pt
    from phe_tpu_torch import benchmarks, profiling
    from phe_tpu_torch.batch import EncryptedBatch
    from phe_tpu_torch.ops import _build, cuda_modexp, cuda_rns
    from phe_tpu_torch.ops import montgomery as mg
    from phe_tpu_torch.ops import rns
    from phe_tpu_torch.utils import limbs as hl

    dev = torch.device("cuda")
    card = profiling.card_line()

    # -- 1. build ----------------------------------------------------------
    t0 = time.time()
    logs = _build.build_all()
    print("build: %.1f s for %s" % (time.time() - t0, ", ".join(logs)))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  %s: %s" % (name, line.strip()))
    print("card: " + card)
    print("torch %s, CUDA %s, %s x%d" % (
        torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
        torch.cuda.device_count()))
    ladder_regs = ptxas_report(logs["rns_ladder"], "rns_ladder_kernel")
    check(len(ladder_regs) == 2 * len(cuda_rns.ELEMS),
          "ptxas reports %d rns_ladder_kernel instantiations" % len(ladder_regs))
    for name, (regs, st, ldb) in sorted(ladder_regs.items()):
        print("rns_ladder ptxas %s: %d registers, %d bytes spill stores, %d "
              "bytes spill loads" % (name, regs, st, ldb))
    sass = tensor_core_sass("rns_ladder", "rns_ladder_kernel", cuda_rns.ELEMS)
    pow_sass = tensor_core_sass("mont_pow", "mont_pow_kernel",
                                cuda_modexp.POW_ELEMS, int_pipe=True)
    mul_sass = tensor_core_sass("mont_mul", "mont_mul_kernel",
                                cuda_modexp.POW_ELEMS, int_pipe=True)

    pub, priv = benchmarks.fixed_key(2048)
    pub8, priv8 = benchmarks.fixed_key(8192)
    t0 = time.time()
    dc = pub.device_context(dev)
    pdc = priv.device_context(dev)
    st = dc.rns_state()
    halves = pdc.rns_state()
    t_keys = time.time() - t0
    print("key constants: %.1f s; the REDC matrices of the five Montgomery "
          "contexts (n^2, p^2, q^2, p, q): %.3f s"
          % (t_keys, redc_seconds(key_contexts(dc, pdc))))
    rng = random.Random(SEED)

    # -- 2. kernels against their plain versions, at the main path's shapes --
    mul_checks = {"mont_mul": [], "mont_mul_const": []}
    geoms = [(dc.ctx, pub.nsquare), (pdc.consts.ctx_p, priv.psquare),
             (pdc.consts.ctx_hp, priv.p)]
    for ctx, M in geoms:
        if ctx.num_limbs != 152:  # the two-operand product never runs mod p^2
            mul_checks["mont_mul"].append(check_mont_mul(ctx, M, False, rng))
        mul_checks["mont_mul_const"].append(check_mont_mul(ctx, M, True,
                                                           rng))
    # The 3072-bit key's n^2 (L = 440) at the encrypt batch, and the
    # 8192-bit key's n^2 (L = 1,176), both in blocks of E = 8 only.
    pub3 = benchmarks.fixed_key(3072)[0]
    ctx3 = mg.build_context(pub3.nsquare, dev)
    dc8 = pub8.device_context(dev)
    for shared, name in ((False, "mont_mul"), (True, "mont_mul_const")):
        mul_checks[name].append(check_mont_mul(ctx3, pub3.nsquare, shared,
                                               rng))
        mul_checks[name].append(check_mont_mul(dc8.ctx, pub8.nsquare, shared,
                                               rng, rows=WIDE_ROWS))
    chain_checks = check_issue_chain(dev)

    def check_ladder(rsys, conv, Lin, digits, exit_int, N, rows=BATCH,
                     few=PLAIN_LADDER_ROWS):
        xs = [rng.randrange(1, 2 * N) for _ in range(rows)]
        x_res = rns.to_rns(limbs_on(xs, Lin, dev), conv, rsys).contiguous()
        head = x_res[:few].contiguous()
        exit_res = rns.residues(exit_int, rsys)
        run = lambda x: cuda_rns.ladder(x, digits, rsys, window=5,
                                        exit_res=exit_res)
        plain = lambda: rns.ladder_plain(head, digits, rsys, window=5,
                                         exit_res=exit_res)
        got = run(x_res)
        torch.cuda.synchronize()
        start = time.perf_counter()
        ref = plain()
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - start)
        check(torch.equal(got[:few], ref), "rns_ladder k=%d: kernel residues "
              "differ from the plain version" % rsys.k)
        e = 0
        for d in digits.cpu().tolist():
            e = (e << 5) | int(d)
        out = hl.limbs_to_ints(rns.from_rns(got[:4], rsys).cpu().numpy())
        for x, v in zip(xs, out):
            check(v % N == pow(x, e, N) * exit_int % N,
                  "rns_ladder k=%d: value differs from Python pow" % rsys.k)
        err = int((got[:few] - ref).abs().max())
        ms = cuda_ms(lambda: run(x_res), 1, warm=False)
        ms_few = cuda_ms(lambda: run(head), 1)
        bms, by = ladder_bound(rows, rsys.k, len(digits), 5)
        bms_few, _ = ladder_bound(few, rsys.k, len(digits), 5)
        elems = ladder_elems(rsys.k, rows)
        print("rns_ladder k=%d cpad=%d windows=%d: bit-equal on %d rows, "
              "Python pow on 4; kernel %.3f ms at %d rows, E = %d (%.3f ms "
              "at %d, E = %d), plain %.3f ms at %d, bound %.3f ms at %d (%s)"
              % (rsys.k, rsys.cpad, len(digits), few, ms, rows, elems,
                 ms_few, few, ladder_elems(rsys.k, few), plain_ms, few,
                 bms, rows, by))
        check(ms >= bms, "rns_ladder k=%d ran under its bound: ladder_bound's "
              "count no longer matches the kernel" % rsys.k)
        return dict(k=rsys.k, rows=rows, elems=elems, max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, plain_rows=few, ms_at_plain_rows=ms_few,
                    bound_ms=bms, bound_ms_at_plain_rows=bms_few, bound_by=by)

    rsys_p, conv_p, _, _ = halves[0]
    R_n = 1 << (14 * dc.L)
    L2 = pdc.consts.ctx_p.num_limbs
    E_p = pow(pow(1 << (14 * L2), -1, priv.psquare), priv.p - 1,
              priv.psquare)
    ladder_checks = [
        check_ladder(st.rsys, st.conv, dc.L, dc.n_digits,
                     R_n % pub.nsquare, pub.nsquare),
        check_ladder(rsys_p, conv_p, L2, pdc.consts.dp_digits, E_p,
                     priv.psquare),
    ]
    # The 8192-bit key's p^2 (k = 624) at its decrypt batch.
    pdc8 = priv8.device_context(dev)
    rsys8, conv8, _, _ = pdc8.rns_state()[0]
    L8 = pdc8.consts.ctx_p.num_limbs
    E_p8 = pow(pow(1 << (14 * L8), -1, priv8.psquare), priv8.p - 1,
               priv8.psquare)
    ladder_checks.append(check_ladder(
        rsys8, conv8, L8, pdc8.consts.dp_digits, E_p8, priv8.psquare,
        rows=LIMB_ROWS, few=PLAIN_LADDER_ROWS_624))
    # The 3072-bit key's n^2 (k = 456) at the encrypt batch.
    dc3 = pub3.device_context(dev)
    st3 = dc3.rns_state()
    ladder_checks.append(check_ladder(
        st3.rsys, st3.conv, dc3.L, dc3.n_digits,
        (1 << (14 * dc3.L)) % pub3.nsquare, pub3.nsquare,
        few=PLAIN_LADDER_ROWS_456))
    check_ragged_ladders(pub, dev, rng)
    check_ragged_pows(pub, dev, rng)
    split = one_product_split(st.rsys, BATCH, dev, card, yardstick=True)
    split_624 = one_product_split(rsys8, LIMB_ROWS, dev, card)
    split_456 = one_product_split(st3.rsys, BATCH, dev, card,
                                  digits=dc3.n_digits)
    turns = ladder_turns(parent, card) if parent else None
    vec_checks = check_vec_kernels(pub, dev, rng)
    # The 3072-bit key's alignment ladder (k = 456) at its 16,384 rows.
    vec_456 = check_ladder_vec(pub3, dev, rng, BATCH)
    select_checks = check_table_select(dev)

    # -- 3. the main path --------------------------------------------------
    vals_rng = np.random.default_rng(SEED)
    values = [float(v) for v in vals_rng.uniform(-1e6, 1e6, BATCH)]
    for _ in range(2):  # the programs' warm-ups, then their captures
        warm = EncryptedBatch.encrypt(pub, values, device=dev)
        check(warm.decrypt(priv) == values, "warm-up round trip failed")

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = EncryptedBatch.encrypt(pub, values, device=dev)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    enc_counts = read_launches()
    t0 = time.perf_counter()
    decrypted = batch.decrypt(priv)
    t_dec = time.perf_counter() - t0
    total = read_launches()
    dec_counts = {k: v - enc_counts.get(k, 0) for k, v in total.items()
                  if v - enc_counts.get(k, 0)}

    check(len(decrypted) == BATCH and decrypted == values,
          "decrypt(encrypt(x)) != x for %d of %d rows" % (
              sum(a != b for a, b in zip(decrypted, values)), BATCH))
    print("main path B=%d: decrypt(encrypt(x)) == x for every row" % BATCH)
    print("launches per encrypt batch: %s" % json.dumps(enc_counts))
    print("launches per decrypt batch: %s" % json.dumps(dec_counts))
    expect_launches("encrypt", enc_counts,
                    {"mont_mul": 1, "mont_mul_const": 1, "rns_ladder": 1})
    expect_launches("decrypt", dec_counts,
                    {"mont_mul": 3, "mont_mul_const": 6, "rns_ladder": 2})
    print("encrypt: %.1f ops/s (%.3f s for %d); decrypt: %.1f ops/s "
          "(%.3f s) [%s]" % (BATCH / t_enc, t_enc, BATCH, BATCH / t_dec,
                              t_dec, card))

    # Pinned r: the ciphertext ints equal the host's exact encryption.
    few = values[:8]
    rs = [rng.randrange(1, pub.n) for _ in few]
    pinned = EncryptedBatch.encrypt(pub, few, r_values=rs, device=dev)
    encs = pt.EncodedNumber.encode_many(pub, few)
    check(pinned.ciphertext_ints(be_secure=False)
          == [pub.raw_encrypt(e.encoding, r_value=r)
              for e, r in zip(encs, rs)],
          "pinned-r ciphertexts differ from the host's raw_encrypt")
    print("pinned-r batch of %d: ciphertext ints equal raw_encrypt" % len(few))

    # One secure export: re-obfuscated ints decrypt on the host.
    fresh = EncryptedBatch.encrypt(pub, few, r_values=rs, device=dev)
    secure = fresh.ciphertext_ints()
    check(fresh.is_obfuscated and secure != pinned.ciphertext_ints(False),
          "secure export did not re-obfuscate")
    check([priv.decrypt(pt.EncryptedNumber(pub, c, int(e)))
           for c, e in zip(secure, fresh.exponents)] == few,
          "secure ciphertexts do not decrypt on the host")
    check(fresh.decrypt(priv) == few, "secure batch does not decrypt")
    print("secure export round trip of %d: ok" % len(few))
    path_launches = dict(total)
    key3 = default_key_path(dev, card, path_launches)

    # -- 4. the arithmetic path --------------------------------------------
    rates = arithmetic_path(pub, priv, dev, card, path_launches)
    print(json.dumps({"arithmetic_rows_per_s": rates, "card": card}))
    t0 = time.time()
    matvec_records = matvec_small_grids([pub, pub3, pub8], dev, card)
    print("matvec small grids: %.1f s" % (time.time() - t0))
    print(json.dumps({"matvec_small_grids": matvec_records, "card": card}))

    # -- 5. the calibration ------------------------------------------------
    calibration(card, path_launches)

    # -- 6. the benchmarks -------------------------------------------------
    benchmark_phase(pub, priv, dev, card, path_launches)

    # -- 7. the limb engine at 8192 bits, and the two-body sweep -----------
    _, wide_checks = limb_engine_path(pub8, priv8, dev, card, path_launches)
    t0 = time.time()
    body_sweep(dev, card)
    print("two-body sweep: %.1f s" % (time.time() - t0))

    # -- 8. wire formats, CLI, CRT powers, mesh ----------------------------
    wire_seconds, crt_check = wire_path(pub, priv, dev, card, path_launches)
    print(json.dumps({"wire_cli_crt_mesh_seconds": wire_seconds,
                      "card": card}))

    # -- 9. the batch programs as captured graphs --------------------------
    t0 = time.time()
    programs = programs_phase([(pub, priv), key3, (pub8, priv8)], dev, card)
    print("programs phase: %.1f s" % (time.time() - t0))
    print(json.dumps({"programs_phase": programs, "card": card}))

    src = {"mont_mul": "phe_tpu_torch/csrc/mont_mul.cu",
           "mont_mul_const": "phe_tpu_torch/csrc/mont_mul.cu",
           "rns_ladder": "phe_tpu_torch/csrc/rns_ladder.cu",
           "rns_ladder_vec": "phe_tpu_torch/csrc/rns_ladder.cu",
           "mont_pow_shared": "phe_tpu_torch/csrc/mont_pow.cu",
           "mont_pow": "phe_tpu_torch/csrc/mont_pow.cu",
           "vpu_microbench": "phe_tpu_torch/csrc/microbench.cu",
           "table_select": "phe_tpu_torch/csrc/table_select.cu"}
    # The integer-pipe REDC bodies: the same kernels' kMxu = false
    # instantiations, phe_tpu's mxu=False branch of the same Pallas calls.
    for name in cuda_modexp.FORMS:
        src[name + "_int"] = src[name]
    replaces = {"mont_mul": "phe_tpu/ops/pallas_modexp.py:378",
                "mont_mul_const": "phe_tpu/ops/pallas_modexp.py:434",
                "rns_ladder": "phe_tpu/ops/pallas_rns.py:234",
                "rns_ladder_vec": "phe_tpu/ops/pallas_rns.py:447",
                "mont_pow_shared": "phe_tpu/ops/pallas_modexp.py:302",
                "mont_pow": "phe_tpu/ops/pallas_modexp.py:570",
                "vpu_microbench": "scripts/vpu_microbench.py:36",
                "table_select": None}  # added for batch._matvec
    for name in list(src):
        if name.endswith("_int"):
            replaces[name] = replaces[name[:-4]]
    ladder_checks[0]["one_product_split"] = split
    ladder_checks[2]["one_product_split"] = split_624
    ladder_checks[3]["one_product_split"] = split_456
    ladder_checks[0]["sass_imma_idp4a"] = sass
    ladder_checks[0]["ptxas"] = {n: dict(registers=r, spill_stores=a,
                                         spill_loads=b)
                                 for n, (r, a, b) in ladder_regs.items()}
    if turns:
        ladder_checks[0]["parent_turns"] = turns
    vec_checks["mont_pow"]["sass_imma_idp4a"] = pow_sass
    mul_checks["mont_mul"][0]["sass_imma_idp4a"] = mul_sass
    checks = {"mont_mul": mul_checks["mont_mul"],
              "mont_mul_const": mul_checks["mont_mul_const"],
              "rns_ladder": ladder_checks}
    checks.update({name: [c] for name, c in vec_checks.items()})
    checks["vpu_microbench"] = chain_checks
    checks["table_select"] = select_checks
    for name, cs in wide_checks.items():
        checks[name].extend(cs)
    checks["rns_ladder_vec"].append(vec_456)
    checks["mont_pow_shared"].append(crt_check)
    # A limb check counts under the kernel its launches ran: <form>_int
    # where _body took the integer pipe (its tile text names the body).
    for form in cuda_modexp.FORMS:
        for c in checks.pop(form):
            int_pipe = c["tile"].startswith("integer-pipe")
            checks.setdefault(form + "_int" * int_pipe, []).append(c)
    for name in src:
        check(path_launches.get(name, 0) > 0,
              "%s was not launched on the main path" % name)
    record = {"kernels": []}
    for name in src:
        first = checks[name][0]  # the main path's widest geometry
        record["kernels"].append({
            "name": name, "route": "cuda", "source": src[name],
            "replaces": replaces[name], "launches": path_launches[name],
            "max_abs_err": max(x["max_abs_err"] for x in checks[name]),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None, "rows": first["rows"],
            "plain_rows": first["plain_rows"], "checks": checks[name],
        })
    print(json.dumps(record))
    print("chip_smoke: %.1f s, the kernels' build included" %
          (time.time() - started))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
