"""Per-op benchmark suite for the port on one NVIDIA GPU.

The port of phe_tpu/benchmarks.py. It mirrors the reference's methodology
(examples/benchmarks.py:38-92: timed batches of encrypt / decrypt /
add(enc,enc) / add(enc,scalar) / add(enc,1) / mul(enc,scalar) across key
sizes) with batch-first device execution: each op is one call on a [B, L]
ciphertext tensor on the card, timed on the host clock around work that
ends in torch.cuda.synchronize, after one warm-up run (kernel build and
per-key constants).

Every JSON row names the device it ran on, so a run on the CPU (the tests
pass device="cpu") can never pass for a card number. The entry points
default to the card and raise without one.

Run on the card:  python -m phe_tpu_torch.benchmarks [--key-sizes 1024,2048]
                  [--batch 512] [--runs 3] [--stream 1] [--mem]
Emits one JSON object per (op, keysize) line, plus a summary table to stderr.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from phe_tpu_torch import config

# op -> {keysize: ops/s of the reference ``phe`` package on one core of
# single-threaded CPython}: phe_tpu's baseline table (BASELINE.md for 1024
# and 2048 bits, its later measurements for 3072-8192), carried over as it
# is. A host figure, not a device one: vs_baseline divides by it.
CPYTHON_BASELINE = {
    "encrypt": {1024: 55.5, 2048: 9.2, 3072: 3.51, 4096: 1.48, 8192: 0.209},
    "decrypt": {1024: 179.0, 2048: 32.7, 3072: 13.16, 4096: 5.67,
                8192: 0.74},
    "add_enc_enc": {1024: 39614.0, 2048: 22218.0, 3072: 7622.0,
                    4096: 6849.0, 8192: 1796.0},
    "mul_enc_scalar": {1024: 386.0, 2048: 297.0, 3072: 157.6, 4096: 67.4,
                       8192: 17.4},
}

# The repository's fixed keys. 2048 bits: the benchmark key (bench.py).
# 8192 bits: drawn once with generate_paillier_keypair(n_length=8192).
_P2048 = int(
    "0xb1014c0adf6a4c106038a6b1a0deabd3d494ff41e3f43e1e3509a6ea863ecbf8"
    "4a689287002393a6a1a5da9c1626b2e76d9b785fd19b8028585b04797a4e967c3"
    "738bbfde71cf7a988bfae01d3787328143277c1b6dbe77c378f7ada3aec653e1a"
    "73353812105a0e2a759c81247a22ab8b79400d6499636cba4dfa86066fd27d",
    16,
)
_Q2048 = int(
    "0xe5b2fa62ee1f2a9153c0b2cda99dac639fc941aa15e2c04aca6ee5751eefff6b"
    "9c3cdb0cb7772e3ca4590d0d03234d7273a580df2fc6251a3d25d4de4ef622e47"
    "7ce51432f90b74cac9fb80ad9fb70226fb0eb6ff545e4d6c5a634e335dd57b005"
    "0e2419b414204578cb5ace3da3321acaaab2c8b7c05b719b9432bb5a8114c9",
    16,
)
# The 3072-bit key (the default size, keys.DEFAULT_KEYSIZE) that phe_tpu's
# tests pin (tests/test_keysize_3072.py).
_P3072 = int(
    "0xa6171f4f81623fd7edebe03d88ef260b37747eadb6cecc412070e5a2a40f0cd8"
    "b63504238c7d8c639afc26725946e8967eff131bcf0db2c0102ca7b54ddd9660"
    "bb6f5e25fcefbf5b38bc4bed335570ca5b94986975ca6203f32edf7fd63ecb19"
    "807ab12093cf39ea26d68abd32a73567c6e531cf1ac880cfd0e2dfd357e62de2"
    "ab1561119d576b4dbddf4a606e265132eb571ca5daddf86f11f3db0e0b6716d9"
    "ce154ede4cc800b0adc68bdaffdb64d3cfee638f0874d5d396e3bee74e2a8441",
    16,
)
_Q3072 = int(
    "0xfe2ca0e92c536303ebacd2703dc56b367212bdb090142a9405cae071492798b1"
    "c708fb173640794e992065d41d871218599422ae10d26d68842ea5c5eced4f95"
    "efad3acb7e01bace8d0ed1d1030830b14b3c6a68d3d18f2e88252356cb68e183"
    "7ca03fb832166259fa703868b06806d2970b5bdfd1f66728225008ad10ac4275"
    "a95038c9da92208d650ba13243b18906b06fefd2c9306f77921ba144a750847d"
    "b5ef044add2b01d351e6c6b851c8877c9a34df83338de589edd7e2b562e9f3bd",
    16,
)
_P8192 = int(
    "0x98015edf2cb4d737f30c34e2a1ff29ea7b6f5589a6f4e8cc22ad0bd9f276e187"
    "bbf967b7bbfc7f1e57f2380d9c647588f3a9a21449e3839ccbb2dffa524f9f10"
    "85e290e78289603aadb20c158d92b32c4d3f931067365b5b318ca0e71bc67228"
    "2eb21068f0b726a7fe5450d93ca2e9891271cd81bdf4750b5034aed6d3cd893f"
    "e14f22ab94dfc133ddb77b93bd4539623a505ce365dd31a79c54d403e3bf8e14"
    "3c02ee0f438d134ec045dc92e79b4f6969ea47ec050e3cfcec5f5077fdded892"
    "4b4d9d474d0bda305800ad246f7b3aa66265d729147f57b0b3d5638ac76516f0"
    "f1702e3fdfc814e5611106ba726097a231112434da4ef3c2cb26741b8a4d39b2"
    "e787440df56adb6ddd4833308550b225817fd68e0f8248cdb7d26458ceda04cb"
    "824dbc87f60f5155a4a3eac05844301719f81b7f29f694417f33ee5243da4790"
    "c6356b1d455829a629611cef49b0de43e30d7b4a2a1c3c23db156b1ab2227637"
    "05745e60cbd1c37b5299ded34921036c6bd5ffa1913462e022fd16d5a52bf561"
    "bb4edde68c4b684347d1e42e88803a961af0cbb961cc6b9dcc8235da38c5aa35"
    "0ec44d0a56ca9a872d1f11c76fe80b95c4885391c18fde3a87f1a9de86443656"
    "de93946737892ece6f1d99ba7e7cfd888d4e8712e29817339f424b1aad95e5d7"
    "78ec34e2a176a5a9cefc1026f45050e5a3eba16d7f30b98daa42e2d445880229",
    16,
)
_Q8192 = int(
    "0xf837ad786adb401050dae36899eae808babff2d79d782e9104344e4de53f9e77"
    "8229ace294da69c922f7ae658314a32da60fb335cf1ca5e7dbf64342d69072b4"
    "b2de9f0b7828fa9445fef1289eda6658ece5041b85536cb16bf46f9ddd2e8b5c"
    "bcd2b7e3cb04511645df88c126505057a1cc77221e936991f3d6f0a23b4c2eb7"
    "69890e52e99bed370fb3ab5c04b11c33ec4fefd2bc7871ded80ca59111f2a8cd"
    "7206d5782e01c26120762a7b9a16f736436c6744bc2e4094aba95a3d417eb69e"
    "a58a5fbe4b47cc1d07708a78b9614b74a2e9a757e57781655cf753aa7330a7dd"
    "7d8e2fe7ac9f8444a9ff08a1dddd1f22e9bd6bbbf6d65f1ea5e8be97d8568f62"
    "686fd7880f1846250d1ecda1111f9e4bca883d5a22a9bf9d0438894740ff3a3b"
    "7d60ff0c12e2ec26b533b6f49334e303d931056b409ae0d78a11b9d940d31ff0"
    "ce8db44749521c4966bdd41b27a1ff15c772a45c984fa2b1c41b4c9f27d3f536"
    "9ad23673f7184753a3bcea16b2b10c16059daa1f68b75cab7f53ea529375ed4b"
    "4b75c8f00bdfa1d64a9b03188ce2702ee5e9fb82222680b26a446f2cae0fe136"
    "bef6ffaf9a9179afd5d49bfbabff2456581741bfc14d34da433c642f88c2e5ca"
    "3659e5bd49e123590d53b7b8905ae0137471332cd7ca4507e65f7e65455adc32"
    "7f3ab8a96a0903f339f6806056e683f604165b22ec8ce011ac025abcad42115d",
    16,
)


def fixed_key(bits):
    """(public, private) of the repository's fixed `bits`-bit key: 2048
    (the benchmark key), 3072 (the default size) or 8192 (the limb-engine
    key)."""
    from phe_tpu_torch.keys import PaillierPrivateKey, PaillierPublicKey

    primes = {2048: (_P2048, _Q2048), 3072: (_P3072, _Q3072),
              8192: (_P8192, _Q8192)}
    if bits not in primes:
        raise ValueError("fixed keys exist for %s bits, not %d"
                         % (sorted(primes), bits))
    p, q = primes[bits]
    pub = PaillierPublicKey(p * q)
    return pub, PaillierPrivateKey(pub, p, q)


def device_name(device):
    """What a result row names as its device: the card's name, or "cpu"."""
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def _time_op(fn, runs=3):
    """Median-of-runs wall time for fn() (fn must fence its device work)."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _sync(b):
    """Fence: wait for the device work behind a batch."""
    if b.mont.is_cuda:
        torch.cuda.synchronize(b.mont.device)
    return b


def op_costs(pub, priv, device):
    """Roofline cost models of encrypt, decrypt, add and mul on the engines
    that actually run them (phe_tpu's bench_key_size chooses them alike):
    the RNS models where the RNS engine fits the modulus (the contexts'
    rns_state()), the limb-engine models otherwise."""
    from phe_tpu_torch import batch as bt
    from phe_tpu_torch import profiling

    dc = pub.device_context(device)
    pdc = priv.device_context(device)
    st = dc.rns_state()
    halves = pdc.rns_state()
    return {
        "encrypt": profiling.rns_encrypt_cost(
            dc.n_bits, st.rsys.k, bt.ENCRYPT_WINDOW
        ) if st is not None else profiling.encrypt_cost(
            dc.n_bits, dc.L, bt.ENCRYPT_WINDOW
        ),
        "decrypt": profiling.rns_decrypt_cost(
            dc.n_bits, halves[0][0].k, bt.DECRYPT_WINDOW
        ) if halves is not None else profiling.decrypt_cost(
            dc.n_bits, pdc.consts.ctx_p.num_limbs, bt.DECRYPT_WINDOW
        ),
        "add": profiling.mont_mul_cost(dc.L),
        # mul: 64-bit scalar exponents on the per-element modexp.
        "mul": profiling.rns_vec_modexp_cost(64, st.rsys.k, bt.DEFAULT_WINDOW)
        if st is not None else profiling.modexp_cost(64, dc.L),
    }


def bench_key_size(keysize, batch, runs=3, emit=print, streams=1,
                   device=None):
    """Per-op suite at one key size on `device` (default: the card).

    streams=1 (default) is single-dispatch latency methodology: each
    timed call fences before the next. streams>1 is bench.py's
    steady-state streamed throughput: that many batches in flight, the
    wall clock charging all host work; the JSON rows carry the streams
    count either way so artifacts self-describe.
    """
    from phe_tpu_torch import profiling
    from phe_tpu_torch.batch import EncryptedBatch
    from phe_tpu_torch.keys import generate_paillier_keypair

    dev = config.resolve_device(device)
    kind = device_name(dev)
    rng = np.random.default_rng(20260817 + keysize)
    vals = [float(v) for v in rng.uniform(-1e6, 1e6, batch)]
    scalars = [float(v) for v in rng.uniform(-100, 100, batch)]

    t0 = time.perf_counter()
    pub, priv = generate_paillier_keypair(n_length=keysize)
    keygen_s = time.perf_counter() - t0

    results = {"keygen": {"value": round(1.0 / keygen_s, 3),
                          "unit": "keypairs/s"}}

    def run(op, launch, finish=_sync, unit="ops/s", per=batch):
        finish(launch())  # warm-up: kernel build, per-key constants
        if streams > 1:
            def fn():
                handles = [launch() for _ in range(streams)]
                for h in handles:
                    finish(h)
            dt = _time_op(fn, runs) / streams
        else:
            dt = _time_op(lambda: finish(launch()), runs)
        ops = per / dt
        base = CPYTHON_BASELINE.get(op, {}).get(keysize)
        results[op] = {
            "value": round(ops, 2),
            "unit": unit,
            "vs_baseline": round(ops / base, 2) if base else None,
            "streams": streams,
        }

    enc = EncryptedBatch.encrypt(pub, vals, device=dev)
    enc2 = EncryptedBatch.encrypt(pub, scalars, device=dev)

    run("encrypt", lambda: EncryptedBatch.encrypt(pub, vals, device=dev))
    run("decrypt", lambda: enc.decrypt_async(priv), finish=lambda f: f())

    # Roofline accounting: achieved fraction of the binding unit's peak,
    # under the cost model of whichever engine actually ran.
    costs = op_costs(pub, priv, dev)
    for op in ("encrypt", "decrypt"):
        results[op]["speed_of_light"] = profiling.report(
            op, results[op]["value"], costs[op])["speed_of_light_fraction"]
    run("add_enc_enc", lambda: enc + enc2)
    run("add_enc_scalar", lambda: enc + scalars)
    run("add_enc_one", lambda: enc + [1.0] * batch)
    run("mul_enc_scalar", lambda: enc * scalars)
    results["add_enc_enc"]["speed_of_light"] = profiling.report(
        "add", results["add_enc_enc"]["value"], costs["add"]
    )["speed_of_light_fraction"]
    results["mul_enc_scalar"]["speed_of_light"] = profiling.report(
        "mul", results["mul_enc_scalar"]["value"], costs["mul"]
    )["speed_of_light_fraction"]
    run("sum_batch", lambda: enc.sum(), unit="elements/s")

    for op, r in results.items():
        emit(json.dumps({"metric": op, "keysize": keysize, "batch": batch,
                         **r, "device": kind}))
    return results


def bench_scaling(keysize=1024, batch=2048, runs=3, emit=print,
                  device=None):
    """Scaling of the encrypted aggregation reduce over the ranks there are.

    Sums one batch over meshes of the first 1, 2, 4, ... ranks of the
    world (phe_tpu.parallel.encrypted_sum_sharded's port) and reports
    elements/s and efficiency against linear scaling from one rank: the
    BASELINE.json north-star metric. Every rank of the world calls this
    (each mesh's groups are made by all of them); ranks outside a mesh
    wait at a barrier. Without a process group the world is this one
    process on ``device``, and only d = 1 runs. Rank 0 draws the key and
    broadcasts it; the values and their pinned r come from seeds, so every
    rank holds the same ciphertexts. Rank 0 emits the rows, which name the
    device, the world and the backend.
    """
    import random

    import torch.distributed as dist

    from phe_tpu_torch.batch import EncryptedBatch
    from phe_tpu_torch.keys import PaillierPublicKey, generate_paillier_keypair
    from phe_tpu_torch.parallel import batch_mesh, encrypted_sum_sharded

    dev = config.resolve_device(device)
    initialized = dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    # One key for the whole world: rank 0 draws it.
    n = [generate_paillier_keypair(n_length=keysize)[0].n if rank == 0
         else None]
    if initialized:
        dist.broadcast_object_list(n, src=0)
    pub = PaillierPublicKey(n[0])
    rng = np.random.default_rng(7)
    vals = [float(v) for v in rng.uniform(-1e3, 1e3, batch)]
    r_rng = random.Random(7)
    rs = [r_rng.randrange(1, pub.n) for _ in vals]
    enc = EncryptedBatch.encrypt(pub, vals, r_values=rs, device=dev)

    platform = {"device": device_name(dev), "world": world,
                "backend": dist.get_backend() if initialized else None}
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= world]
    base_rate = None
    out = {}
    for d in sizes:
        mesh = batch_mesh(n_devices=d)
        if mesh.member:
            def fn():
                total = encrypted_sum_sharded(enc, mesh)
                _sync(total)
            fn()  # warm-up
            dt = _time_op(fn, runs)
        if initialized:
            dist.barrier()
        if rank != 0:
            continue
        rate = batch / dt
        if base_rate is None:
            base_rate = rate
        out[d] = {"elements_per_s": round(rate, 1),
                  "scaling_efficiency": round(rate / (base_rate * d), 3)}
        emit(json.dumps({"metric": "encrypted_sum_scaling", "devices": d,
                         "keysize": keysize, "batch": batch, **out[d],
                         **platform}))
    return out


def _rss_kb():
    """This process's resident set now, in KiB (Linux /proc)."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") // 1024


def bench_mem(keysize=2048, test_size=100_000, step=10_000, emit=print,
              device=None):
    """Memory per held ciphertext: host RSS and the card's bytes.

    The reference measures ru_maxrss growth while holding a list of
    EncryptedNumber objects (examples/benchmarks.py:74-86). Here the host
    measurement runs against EncryptedBatch (ciphertexts resident on the
    card, the host holds metadata only) and reads the resident set as it
    is (/proc/self/statm), from after the key's device context is built:
    ru_maxrss is a high-water mark, and any earlier peak of the process
    hides the growth under it. Beside it, the exact device footprint: a
    ciphertext is one Montgomery limb row of L int64 limbs, so device
    bytes per ciphertext = mont.element_size() * L (8 L), the number that
    bounds feasible batch sizes on the card.
    """
    from phe_tpu_torch.batch import EncryptedBatch
    from phe_tpu_torch.keys import generate_paillier_keypair

    dev = config.resolve_device(device)
    kind = device_name(dev)
    pub, _ = generate_paillier_keypair(n_length=keysize)
    dc = pub.device_context(dev)
    dc.rns_state()
    L = dc.L
    r_init = _rss_kb()
    rng = np.random.default_rng(1)
    held = []
    per_ct = None
    for i in range(0, test_size, step):
        vals = [float(v) for v in rng.uniform(-1e6, 1e6, step)]
        held.append(_sync(EncryptedBatch.encrypt(pub, vals, device=dev)))
        if per_ct is None:
            mont = held[0].mont
            per_ct = mont.element_size() * L
            emit(json.dumps({
                "metric": "device_bytes_per_ciphertext", "keysize": keysize,
                "value": per_ct, "unit": "bytes", "device": kind,
                "note": "%s[L=%d] Montgomery limb row mod n^2"
                        % (str(mont.dtype).replace("torch.", ""), L),
            }))
        n = i + step
        rss_kb = _rss_kb() - r_init
        emit(json.dumps({
            "metric": "host_rss_per_ciphertext", "keysize": keysize,
            "held": n, "rss_kb": rss_kb,
            "value": round(1024.0 * rss_kb / n, 1), "unit": "bytes",
            "device": kind,
        }))
    return {"device_bytes_per_ciphertext": per_ct}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--key-sizes", default="1024,2048",
                    help="comma-separated bit lengths")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--stream", type=int, default=1, metavar="N",
                    help="batches in flight per timed run (1 = "
                         "single-dispatch latency methodology; bench.py "
                         "uses 4 for steady-state throughput)")
    ap.add_argument("--scaling", action="store_true",
                    help="also run the scaling sweep of the encrypted sum "
                         "over the ranks of the process group (one rank "
                         "without one)")
    ap.add_argument("--mem", action="store_true",
                    help="also run the memory-per-ciphertext benchmark")
    args = ap.parse_args(argv)

    key_sizes = [int(s) for s in args.key_sizes.split(",")]
    all_results = {}
    for ks in key_sizes:
        all_results[ks] = bench_key_size(ks, args.batch, args.runs,
                                         streams=args.stream)
    if args.scaling:
        bench_scaling(keysize=key_sizes[0], batch=args.batch, runs=args.runs)
    if args.mem:
        bench_mem(keysize=key_sizes[-1])

    print("\n== summary (ops/s, vs single-core CPython baseline) ==",
          file=sys.stderr)
    for ks, res in all_results.items():
        for op, r in res.items():
            vs = r.get("vs_baseline")
            print("  %5d-bit %-16s %12.1f %s%s" % (
                ks, op, r["value"], r["unit"],
                "  (%.0fx baseline)" % vs if vs else ""), file=sys.stderr)
    return all_results


if __name__ == "__main__":
    main()
