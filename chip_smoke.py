"""Drive phe_tpu_torch's main path on one NVIDIA GPU and check every kernel.

Run from the repository root:  python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. Build every CUDA kernel from the checkout's sources (one nvcc per
   source, started together); print the build seconds, the compiler's
   per-kernel register and spill report, and the card's name and power
   limit.
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes: 16,384 rows at the fixed 2048-bit key. The
   Montgomery product runs at L = 296 (n^2), 152 (p^2) and 80 (p) and is
   checked value mod M against the plain version and Python ints, with the
   limb and value bounds. The RNS ladder runs at k = 304 (exponent n, exit
   R) and k = 152 (exponent p-1, exit R^(1-p)); its first 128 rows are
   checked bit-equal against the plain version, which is too slow for the
   whole batch, and four rows against Python pow. The tolerance is zero
   everywhere: this is exact integer arithmetic.
   The per-element-exponent kernels run at their path's shapes too: the
   RNS ladder at k = 304, window 4, over 65,536 rows of 64-bit schedules
   (bit-equal to its plain version on the first 1,024 rows, four rows
   against Python pow); the limb-engine modexp at L = 296 over 16,384
   rows of 320-bit schedules (value-equal on 1,024 rows, four against
   Python pow); its shared-exponent form with the exponent n on one row
   and on 128 rows.
3. The main path at 16,384 ciphertexts: EncryptedBatch.encrypt of seeded
   uniform floats in +-1e6, then decrypt, with every kernel's launch count
   read around it; a pinned-r batch against the host's raw_encrypt; one
   secure export round trip; encrypt and decrypt ops/s.
4. The arithmetic path, each step with the counts zeroed just before it
   and read just after, checked exactly against the host and timed on the
   host clock: add at equal exponents over 524,288 rows and aligned over
   65,536, add_scalars aligned, mul_scalars with mixed-sign floats over
   65,536 rows, sum and dot at mixed exponents, encrypted
   logistic-regression scoring of 1,024 examples x 21 weights, federated
   aggregation of 5 x 16,384 gradients, and short-obfuscated encryption.
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
   channel supply (see limb_engine_path).

The second-to-last lines are the kernels' JSON record and the card's
name and power limit; the last line is the device record. Kernel times are
CUDA-event times; bounds use NVIDIA's published H100 SXM peaks, and for
the issue-rate chain the instructions its SASS issues (CHAIN_ISSUE).
"""

import json
import random
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


def fail(msg):
    print("FAILED: " + msg, file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


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


def mont_pow_bound(rows, L, products, digit_bytes):
    """Windowed limb-engine modexp: `products` two-operand Montgomery
    products per row, each counted as mont_mul_bound counts one (12 L^2
    int8 multiply-adds for REDC, L^2 int32 for a*b). Bytes: the int64 base
    rows in and out, M, M' and R mod M, the digits and the REDC digit
    matrices, each read once."""
    nbytes = 8 * (2 * rows * L + 3 * L) + digit_bytes + 12 * L * L
    return bound_ms(nbytes, int8_macs=rows * products * 12 * L * L,
                    int32_ops=rows * products * L * L)


def sync():
    torch.cuda.synchronize()


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


def expect_launches(step, counts, want):
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


def check_vec_kernels(pub, dev, rng):
    """Phase 2, the per-element-exponent kernels against their plain
    versions at the arithmetic path's shapes; {kernel name: record}."""
    from phe_tpu_torch import batch as tbatch
    from phe_tpu_torch.ops import cuda_modexp, cuda_rns
    from phe_tpu_torch.ops import montgomery as mg
    from phe_tpu_torch.ops import rns
    from phe_tpu_torch.utils import limbs as hl

    dc = pub.device_context(dev)
    st, ctx, L, N = dc.rns_state(), dc.ctx, dc.L, pub.nsquare
    R = 1 << (14 * L)
    R_inv = pow(R, -1, N)
    few = PLAIN_VEC_ROWS
    out = {}

    def host_timed(fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, 1e3 * (time.perf_counter() - t0)

    def canonical_err(got, ref):
        """max |canonical(got) - canonical(ref)| over the limbs, on the card:
        both are < 1.01 M, so their canonical forms are the values mod M."""
        return int((mg.export_canonical(got, ctx)
                    - mg.export_canonical(ref, ctx)).abs().max())

    # rns_ladder_vec: mul_scalars' shape (65,536 rows of 64-bit schedules,
    # window 4) on Montgomery-domain operands, entry M_A^2 R^-1, exit R.
    rows = MUL_ROWS
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
    check(torch.equal(got[:few], ref), "rns_ladder_vec: kernel residues "
          "differ from the plain version")
    tail = list(range(4)) + [rows - 3, rows - 2, rows - 1]
    vals = hl.limbs_to_ints(rns.from_rns(got[tail], st.rsys).cpu().numpy())
    for i, v in zip(tail, vals):
        check(v % N == pow(xs[i] * R_inv, es[i], N) * R % N,
              "rns_ladder_vec: value differs from Python pow")
    ms = cuda_ms(lambda: run(x_res, digits), 1, warm=False)
    ms_few = cuda_ms(lambda: run(head, dhead), 1)
    bms, by = ladder_bound(rows, st.rsys.k, n_windows, 4, vec=True)
    select_ms = 1e3 * (rows * n_windows * 16 * st.rsys.cpad * 4
                       / HBM_BYTES_PER_S)
    print("rns_ladder_vec k=%d windows=%d: bit-equal on %d rows, Python pow "
          "on %d; kernel %.3f ms at %d rows (%.3f ms at %d), plain %.3f ms "
          "at %d, bound %.3f ms at %d (%s); the table select's reads alone "
          "%.3f ms at HBM rate"
          % (st.rsys.k, n_windows, few, len(tail), ms, rows, ms_few, few,
             plain_ms, few, bms, rows, by, select_ms))
    out["rns_ladder_vec"] = dict(
        k=st.rsys.k, rows=rows, max_abs_err=int((got[:few] - ref).abs().max()),
        ms=ms, plain_ms=plain_ms, plain_rows=few, ms_at_plain_rows=ms_few,
        bound_ms=bms, bound_by=by, select_bytes_ms=select_ms)
    del x_res, got, ref

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
    products = (2**4 - 2) + n_windows * 5
    bms, by = mont_pow_bound(rows, L, products, rows * n_windows)
    print("mont_pow L=%d windows=%d: value-equal on %d rows, Python pow on "
          "6; kernel %.3f ms at %d rows, plain %.3f ms at %d, bound %.3f ms "
          "(%s, %d products a row)"
          % (L, n_windows, few, ms, rows, plain_ms, few, bms, by, products))
    out["mont_pow"] = dict(L=L, rows=rows, max_abs_err=err, ms=ms,
                           plain_ms=plain_ms, plain_rows=few, bound_ms=bms,
                           bound_by=by, products=products)
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
    products = (2**5 - 2) + len(ndig) * 6
    bms, by = mont_pow_bound(1, L, products, 8 * len(ndig))
    print("mont_pow_shared L=%d windows=%d: value-equal on 1 and %d rows, "
          "Python pow on 4; kernel %.3f ms at 1 row (%.3f ms at %d), plain "
          "%.3f ms at 1 row (%.3f ms at %d), bound %.4f ms at 1 row (%s, "
          "%d products)" % (L, len(ndig), rows, ms, ms_rows, rows, plain_ms,
                            plain_ms_rows, rows, bms, by, products))
    out["mont_pow_shared"] = dict(
        L=L, rows=1, max_abs_err=err, ms=ms, plain_ms=plain_ms, plain_rows=1,
        ms_at_128_rows=ms_rows, plain_ms_at_128_rows=plain_ms_rows,
        bound_ms=bms, bound_by=by, products=products)
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

    def decrypt_all(batch):
        """Decrypt in BATCH-row slices (the decrypt ladders' scratch grows
        with the rows)."""
        out = []
        for lo in range(0, len(batch), BATCH):
            part = EncryptedBatch(pub, batch.mont[lo : lo + BATCH],
                                  batch.exponents[lo : lo + BATCH])
            out += part.decrypt(priv)
        return out

    def exact_sum(terms):
        return float(sum(terms, Fraction(0)))

    # add at equal exponents: one list for both operands (bench.py's add).
    xs = floats(-1e6, 1e6, ADD_ROWS)
    ct = EncryptedBatch.encrypt(pub, xs, obfuscation="none", device=dev)
    ct2 = EncryptedBatch.encrypt(pub, xs, obfuscation="none", device=dev)
    s, sec, n = run_step(lambda: ct + ct2, totals)
    expect_launches("add", n, {"mont_mul": 1})
    report("add, equal exponents", ADD_ROWS, sec, n)
    check(decrypt_all(s) == [x + x for x in xs], "add: decrypt(x + x) != x + x")
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
    check(decrypt_all(s) == [x + y for x, y in zip(xa, yb)],
          "aligned add: decrypt(x + y) != x + y")
    sc = floats(-1e-3, 1e-3, MUL_ROWS)
    s, sec, n = run_step(lambda: a + sc, totals)
    expect_launches("add_scalars", n, {"rns_ladder_vec": 1,
                                       "mont_mul_const": 1, "mont_mul": 1})
    report("add_scalars, aligned", MUL_ROWS, sec, n)
    check(decrypt_all(s) == [x + y for x, y in zip(xa, sc)],
          "add_scalars: decrypt(x + s) != x + s")
    sc = floats(-100.0, 100.0, MUL_ROWS)
    s, sec, n = run_step(lambda: a * sc, totals)
    mm, mc = inverse_launches(a.mont.shape[0], chunk)
    expect_launches("mul_scalars", n, {"rns_ladder_vec": 1, "mont_mul": mm,
                                       "mont_mul_const": mc})
    report("mul_scalars, mixed sign", MUL_ROWS, sec, n)
    check(decrypt_all(s) == [x * y for x, y in zip(xa, sc)],
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
    mm, mc = inverse_launches(scorer.weights.mont.shape[0], chunk)
    expect_launches("LR scoring", n, {"rns_ladder_vec": 1,
                                      "mont_mul": mm + tree_depth(D),
                                      "mont_mul_const": mc})
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
    check(decrypt_all(s) == [exact_sum(Fraction(float(gr[d])) for gr in grads)
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
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    total, cur_start, cur_end = 0, None, None
    for a, b in spans:
        if cur_end is None or a > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def benchmark_phase(pub, priv, dev, card, totals):
    """Phase 6: bench.main (BENCH_RUNS timed, BENCH_WARMUP untimed streamed
    passes per op), benchmarks.main at 1024 and 2048 bits with --mem, and
    one BATCH-row encrypt and decrypt under profiling.trace."""
    from phe_tpu_torch import bench, benchmarks, profiling
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
    with profiling.trace() as prof:
        t0 = time.perf_counter()
        out = EncryptedBatch.encrypt(pub, values, device=dev).decrypt(priv)
        sync()
        wall_us = 1e6 * (time.perf_counter() - t0)
    check(out == values, "profiled round trip: decrypt(encrypt(x)) != x")
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profiler: no device time over the %d-row encrypt and decrypt "
              "(%.1f ms on the host clock) [%s]" % (BATCH, wall_us / 1e3,
                                                    card))
        return
    busy = _busy_us(kernels)
    print("profiler: %d-row encrypt and decrypt, %.1f ms on the host clock, "
          "device busy %.1f ms (%.1f %%), %d kernel launches [%s]"
          % (BATCH, wall_us / 1e3, busy / 1e3, 100 * busy / wall_us,
             len(kernels), card))
    rows = [a for a in prof.key_averages()
            if a.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda a: a.self_device_time_total, reverse=True)
    print("profiler top ten by device time (ms, calls, name):")
    for a in rows[:10]:
        print("  %10.3f %6d  %s" % (a.self_device_time_total / 1e3, a.count,
                                    a.key[:100]))


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
    against the RNS decrypt. The plain modexp at L = 1,176 with an
    8192-bit exponent would take minutes, so mont_pow_shared is held
    against Python's pow on 2 rows, and mont_pow against its plain version
    on 64-bit schedules over LIMB_POW_ROWS rows.

    Returns ({BENCH_8192.json metric: ops/s}, {kernel: its L = 1,176
    check record}).
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
    enc, sec, n = run_step(
        lambda: EncryptedBatch.encrypt(pub, xs, device=dev), totals)
    # to_mont(r) and the (n*m + 1) prologue: two shared-operand products.
    expect_launches("8192-bit encrypt", n, {
        "mont_pow_shared": 1, "mont_mul_const": 2, "mont_mul": 1})
    report("encrypt", rows, sec, n, "paillier_encrypt_8192_batched")
    dec, sec, n = run_step(lambda: enc.decrypt(priv), totals)
    expect_launches("8192-bit decrypt", n, {
        "rns_ladder": 2, "mont_mul": 3, "mont_mul_const": 6})
    report("decrypt", rows, sec, n, "paillier_decrypt_8192_batched")
    check(dec == xs, "8192-bit decrypt(encrypt(x)) != x")

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
          and hl.limbs_to_ints(pdc._residue(head).cpu().numpy()) == want,
          "_decrypt_residue_limb differs from the RNS decrypt")

    # The kernels at L = 1,176, as the path runs them.
    ctx, L = dc.ctx, dc.L
    R = 1 << (14 * L)
    R_inv = pow(R, -1, nsq)
    wide = {}
    xs2 = [rng.randrange(0, 2 * nsq) for _ in range(2)]
    base = mg._tensor(hl.ints_to_limbs(xs2, L), dev)
    got, ms = cuda_once(lambda: cuda_modexp.mont_pow_shared(
        base, dc.n_digits, ctx, window=5))
    t0 = time.perf_counter()
    want = [pow(x * R_inv, pub.n, nsq) * R % nsq for x in xs2]
    py_ms = 1e3 * (time.perf_counter() - t0)
    gi = hl.limbs_to_ints(got.cpu().numpy())
    check([v % nsq for v in gi] == want and int(got.min()) >= 0
          and int(got.max()) <= 1 << 14 and all(100 * v < 101 * nsq
                                                 for v in gi),
          "mont_pow_shared L=%d: value differs from Python pow" % L)
    products = (2**5 - 2) + len(dc.n_digits) * 6
    bms, by = mont_pow_bound(2, L, products, 8 * len(dc.n_digits))
    print("mont_pow_shared L=%d windows=%d: Python pow on 2 rows; kernel "
          "%.3f ms at 2 rows, Python pow %.1f ms, bound %.4f ms (%s, %d "
          "products a row)" % (L, len(dc.n_digits), ms, py_ms, bms, by,
                               products))
    wide["mont_pow_shared"] = dict(
        L=L, rows=2, max_abs_err=0, ms=ms, plain_ms=None, plain_rows=0,
        python_pow_ms=py_ms, bound_ms=bms, bound_by=by, products=products)

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
    products = (2**4 - 2) + n_windows * 5
    bms, by = mont_pow_bound(rows_p, L, products, rows_p * n_windows)
    print("mont_pow L=%d windows=%d: value-equal on %d rows, Python pow on "
          "4; kernel %.3f ms, plain %.3f ms, bound %.4f ms (%s, %d products "
          "a row)" % (L, n_windows, rows_p, ms, plain_ms, bms, by, products))
    wide["mont_pow"] = dict(L=L, rows=rows_p, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, plain_rows=rows_p,
                            bound_ms=bms, bound_by=by, products=products)
    print(json.dumps({"paillier_8192": {
        m: {"value": v, "unit": "ops/s", "batch": rows}
        for m, v in rates.items()}, "card": card}))
    return rates, wide


def main():
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

    pub, priv = benchmarks.fixed_key(2048)
    pub8, priv8 = benchmarks.fixed_key(8192)
    t0 = time.time()
    dc = pub.device_context(dev)
    pdc = priv.device_context(dev)
    st = dc.rns_state()
    halves = pdc.rns_state()
    print("key constants: %.1f s" % (time.time() - t0))
    rng = random.Random(SEED)

    # -- 2. kernels against their plain versions, at the main path's shapes --
    def limbs_of(values, L):
        return mg._tensor(hl.ints_to_limbs(values, L), dev)

    def check_mont_mul(ctx, M, shared, rows=BATCH):
        L = ctx.num_limbs
        R_inv = pow(1 << (14 * L), -1, M)
        xs = [rng.randrange(0, 2 * M) for _ in range(rows)]
        ys = [rng.randrange(0, 2 * M) for _ in range(1 if shared else rows)]
        a = limbs_of(xs, L)
        b = limbs_of(ys, L)[0] if shared else limbs_of(ys, L)
        fn = cuda_modexp.mont_mul_const if shared else cuda_modexp.mont_mul
        chunk = max(1, PLAIN_CHUNK * 296 * 296 // (L * L))

        def plain():
            return torch.cat([
                cuda_modexp.mont_mul_plain(
                    a[i : i + chunk], b if shared else b[i : i + chunk], ctx)
                for i in range(0, rows, chunk)])

        got = fn(a, b, ctx)
        ref = plain()
        torch.cuda.synchronize()
        name = "mont_mul_const" if shared else "mont_mul"
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
        bms, by = mont_mul_bound(rows, L, shared)
        print("%s L=%d rows=%d: value-equal, bounds hold; kernel %.4f ms, "
              "plain %.4f ms, bound %.4f ms (%s)"
              % (name, L, rows, ms, plain_ms, bms, by))
        return dict(L=L, rows=rows, max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, plain_rows=rows, bound_ms=bms,
                    bound_by=by)

    mul_checks = {"mont_mul": [], "mont_mul_const": []}
    geoms = [(dc.ctx, pub.nsquare), (pdc.consts.ctx_p, priv.psquare),
             (pdc.consts.ctx_hp, priv.p)]
    for ctx, M in geoms:
        if ctx.num_limbs != 152:  # the two-operand product never runs mod p^2
            mul_checks["mont_mul"].append(check_mont_mul(ctx, M, False))
        mul_checks["mont_mul_const"].append(check_mont_mul(ctx, M, True))
    # The 8192-bit key's n^2 (L = 1,176: 55 KB of shared memory a block).
    dc8 = pub8.device_context(dev)
    for shared, name in ((False, "mont_mul"), (True, "mont_mul_const")):
        mul_checks[name].append(
            check_mont_mul(dc8.ctx, pub8.nsquare, shared, rows=WIDE_ROWS))
    chain_checks = check_issue_chain(dev)

    def check_ladder(rsys, conv, Lin, digits, exit_int, N):
        few = PLAIN_LADDER_ROWS
        xs = [rng.randrange(1, 2 * N) for _ in range(BATCH)]
        x_res = rns.to_rns(limbs_of(xs, Lin), conv, rsys).contiguous()
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
        bms, by = ladder_bound(BATCH, rsys.k, len(digits), 5)
        bms_few, _ = ladder_bound(few, rsys.k, len(digits), 5)
        print("rns_ladder k=%d cpad=%d windows=%d: bit-equal on %d rows; "
              "kernel %.3f ms at %d rows (%.3f ms at %d), plain %.3f ms at "
              "%d, bound %.3f ms at %d (%s)"
              % (rsys.k, rsys.cpad, len(digits), few, ms, BATCH, ms_few, few,
                 plain_ms, few, bms, BATCH, by))
        return dict(k=rsys.k, rows=BATCH, max_abs_err=err, ms=ms,
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
    vec_checks = check_vec_kernels(pub, dev, rng)

    # -- 3. the main path --------------------------------------------------
    vals_rng = np.random.default_rng(SEED)
    values = [float(v) for v in vals_rng.uniform(-1e6, 1e6, BATCH)]
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
    check(enc_counts == {"mont_mul": 1, "mont_mul_const": 1, "rns_ladder": 1},
          "encrypt did not launch each kernel as expected")
    check(dec_counts == {"mont_mul": 3, "mont_mul_const": 6, "rns_ladder": 2},
          "decrypt did not launch each kernel as expected")
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

    # -- 4. the arithmetic path --------------------------------------------
    path_launches = dict(total)
    rates = arithmetic_path(pub, priv, dev, card, path_launches)
    print(json.dumps({"arithmetic_rows_per_s": rates, "card": card}))

    # -- 5. the calibration ------------------------------------------------
    calibration(card, path_launches)

    # -- 6. the benchmarks -------------------------------------------------
    benchmark_phase(pub, priv, dev, card, path_launches)

    # -- 7. the limb engine at 8192 bits -----------------------------------
    _, wide_checks = limb_engine_path(pub8, priv8, dev, card, path_launches)

    src = {"mont_mul": "phe_tpu_torch/csrc/mont_mul.cu",
           "mont_mul_const": "phe_tpu_torch/csrc/mont_mul.cu",
           "rns_ladder": "phe_tpu_torch/csrc/rns_ladder.cu",
           "rns_ladder_vec": "phe_tpu_torch/csrc/rns_ladder.cu",
           "mont_pow_shared": "phe_tpu_torch/csrc/mont_pow.cu",
           "mont_pow": "phe_tpu_torch/csrc/mont_pow.cu",
           "vpu_microbench": "phe_tpu_torch/csrc/microbench.cu"}
    replaces = {"mont_mul": "phe_tpu/ops/pallas_modexp.py:378",
                "mont_mul_const": "phe_tpu/ops/pallas_modexp.py:434",
                "rns_ladder": "phe_tpu/ops/pallas_rns.py:234",
                "rns_ladder_vec": "phe_tpu/ops/pallas_rns.py:447",
                "mont_pow_shared": "phe_tpu/ops/pallas_modexp.py:302",
                "mont_pow": "phe_tpu/ops/pallas_modexp.py:570",
                "vpu_microbench": "scripts/vpu_microbench.py:36"}
    checks = {"mont_mul": mul_checks["mont_mul"],
              "mont_mul_const": mul_checks["mont_mul_const"],
              "rns_ladder": ladder_checks}
    checks.update({name: [c] for name, c in vec_checks.items()})
    checks["vpu_microbench"] = chain_checks
    for name, c in wide_checks.items():
        checks[name].append(c)
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
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
