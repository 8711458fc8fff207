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
3. The main path at 16,384 ciphertexts: EncryptedBatch.encrypt of seeded
   uniform floats in +-1e6, then decrypt, with every kernel's launch count
   read around it; a pinned-r batch against the host's raw_encrypt; one
   secure export round trip; encrypt and decrypt ops/s.

The second-to-last lines are the kernels' JSON record and the card's
name and power limit; the last line is the device record. Kernel times are
CUDA-event times; bounds use NVIDIA's published H100 SXM peaks.
"""

import json
import random
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 16384  # encrypt and decrypt batch (the repo's headline workload)
SEED = 20261016
PLAIN_CHUNK = 2048  # rows per plain Montgomery product (bounds its memory)
PLAIN_LADDER_ROWS = 128  # rows of the plain ladder check (>= 64)

# Fixed 2048-bit key (the repository's benchmark key).
P = int(
    "0xb1014c0adf6a4c106038a6b1a0deabd3d494ff41e3f43e1e3509a6ea863ecbf8"
    "4a689287002393a6a1a5da9c1626b2e76d9b785fd19b8028585b04797a4e967c3"
    "738bbfde71cf7a988bfae01d3787328143277c1b6dbe77c378f7ada3aec653e1a"
    "73353812105a0e2a759c81247a22ab8b79400d6499636cba4dfa86066fd27d",
    16,
)
Q = int(
    "0xe5b2fa62ee1f2a9153c0b2cda99dac639fc941aa15e2c04aca6ee5751eefff6b"
    "9c3cdb0cb7772e3ca4590d0d03234d7273a580df2fc6251a3d25d4de4ef622e47"
    "7ce51432f90b74cac9fb80ad9fb70226fb0eb6ff545e4d6c5a634e335dd57b005"
    "0e2419b414204578cb5ace3da3321acaaab2c8b7c05b719b9432bb5a8114c9",
    16,
)

# NVIDIA H100 SXM published peaks (data sheet; Hopper white paper).
HBM_BYTES_PER_S = 3.35e12
INT8_MAC_PER_S = 1979e12 / 2  # 1,979 TOP/s int8 dense, 2 ops per MAC
# 64 INT32 lanes per SM x 132 SMs x 1.98 GHz (the clock behind the 67
# TFLOP/s fp32 peak): integer multiply-adds, shifts, compares per second.
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def fail(msg):
    print("FAILED: " + msg, file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ""


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


def ladder_bound(rows, k, n_windows, window):
    """RNS ladder: per Montgomery product and element, two base extensions
    of 3(k+8) x 2k int8 multiply-adds, and the channel arithmetic: about
    cpad + 31k + 65(k+8) int32 operations (channel product; sigma with its
    Barrett reduction and digits; q^ and u~ with two digit recombinations
    and three Barrett reductions; S, the beta fold and its reduction)."""
    cpad, K1 = 2 * k + 8, k + 8
    products = 2 + (2**window - 2) + n_windows * (window + 1)
    int8 = rows * products * 2 * (3 * K1) * (2 * k)
    int32 = rows * products * (cpad + 31 * k + 65 * K1)
    nbytes = 8 * (2 * rows * cpad + 12 * cpad + n_windows) + 2 * 3 * K1 * 2 * k
    return bound_ms(nbytes, int8_macs=int8, int32_ops=int32)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import phe_tpu_torch as pt
    from phe_tpu_torch.batch import EncryptedBatch
    from phe_tpu_torch.ops import _build, cuda_modexp, cuda_rns
    from phe_tpu_torch.ops import montgomery as mg
    from phe_tpu_torch.ops import rns
    from phe_tpu_torch.utils import limbs as hl

    dev = torch.device("cuda")
    card = card_line()

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

    pub = pt.PaillierPublicKey(P * Q)
    priv = pt.PaillierPrivateKey(pub, P, Q)
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

    def check_mont_mul(ctx, M, shared):
        L = ctx.num_limbs
        R_inv = pow(1 << (14 * L), -1, M)
        xs = [rng.randrange(0, 2 * M) for _ in range(BATCH)]
        ys = [rng.randrange(0, 2 * M) for _ in range(1 if shared else BATCH)]
        a = limbs_of(xs, L)
        b = limbs_of(ys, L)[0] if shared else limbs_of(ys, L)
        fn = cuda_modexp.mont_mul_const if shared else cuda_modexp.mont_mul

        def plain():
            return torch.cat([
                cuda_modexp.mont_mul_plain(
                    a[i : i + PLAIN_CHUNK],
                    b if shared else b[i : i + PLAIN_CHUNK], ctx)
                for i in range(0, BATCH, PLAIN_CHUNK)])

        got = fn(a, b, ctx)
        ref = plain()
        torch.cuda.synchronize()
        name = "mont_mul_const" if shared else "mont_mul"
        g = hl.limbs_to_ints(got.cpu().numpy())
        want = [x * (ys[0] if shared else y) * R_inv % M
                for x, y in zip(xs, ys * BATCH if shared else ys)]
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
        bms, by = mont_mul_bound(BATCH, L, shared)
        print("%s L=%d rows=%d: value-equal, bounds hold; kernel %.4f ms, "
              "plain %.4f ms, bound %.4f ms (%s)"
              % (name, L, BATCH, ms, plain_ms, bms, by))
        return dict(L=L, rows=BATCH, max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, plain_rows=BATCH, bound_ms=bms,
                    bound_by=by)

    mul_checks = {"mont_mul": [], "mont_mul_const": []}
    geoms = [(dc.ctx, pub.nsquare), (pdc.consts.ctx_p, priv.psquare),
             (pdc.consts.ctx_hp, priv.p)]
    for ctx, M in geoms:
        if ctx.num_limbs != 152:  # the two-operand product never runs mod p^2
            mul_checks["mont_mul"].append(check_mont_mul(ctx, M, False))
        mul_checks["mont_mul_const"].append(check_mont_mul(ctx, M, True))

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

    # -- 3. the main path --------------------------------------------------
    vals_rng = np.random.default_rng(SEED)
    values = [float(v) for v in vals_rng.uniform(-1e6, 1e6, BATCH)]
    warm = EncryptedBatch.encrypt(pub, values, device=dev)
    check(warm.decrypt(priv) == values, "warm-up round trip failed")

    counts = [cuda_modexp.launches, cuda_rns.launches]
    for c in counts:
        for key in c:
            c[key] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = EncryptedBatch.encrypt(pub, values, device=dev)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    enc_counts = {k: v for c in counts for k, v in c.items()}
    t0 = time.perf_counter()
    decrypted = batch.decrypt(priv)
    t_dec = time.perf_counter() - t0
    total = {k: v for c in counts for k, v in c.items()}
    dec_counts = {k: total[k] - enc_counts[k] for k in total}

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

    src = {"mont_mul": "phe_tpu_torch/csrc/mont_mul.cu",
           "mont_mul_const": "phe_tpu_torch/csrc/mont_mul.cu",
           "rns_ladder": "phe_tpu_torch/csrc/rns_ladder.cu"}
    replaces = {"mont_mul": "phe_tpu/ops/pallas_modexp.py:378",
                "mont_mul_const": "phe_tpu/ops/pallas_modexp.py:434",
                "rns_ladder": "phe_tpu/ops/pallas_rns.py:234"}
    checks = {"mont_mul": mul_checks["mont_mul"],
              "mont_mul_const": mul_checks["mont_mul_const"],
              "rns_ladder": ladder_checks}
    record = {"kernels": []}
    for name in ("mont_mul", "mont_mul_const", "rns_ladder"):
        first = checks[name][0]  # the widest geometry: n^2
        record["kernels"].append({
            "name": name, "route": "cuda", "source": src[name],
            "replaces": replaces[name], "launches": total[name],
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
