"""Headline benchmark: batched 2048-bit Paillier throughput on one GPU.

The port of the repository's bench.py. Prints one JSON line {"metric",
"value", "unit", "vs_baseline", "device", "speed_of_light", "bound_by"}
per op: encrypt first, then decrypt, add and scalar multiply, the
reference's benchmark set (examples/benchmarks.py:38-71). Baselines are
the reference's single-core CPython rates at 2048 bits (phe_tpu's
BASELINE.md): encrypt 9.2 ops/s, decrypt 32.7, add 22,218, mul 297.

Methodology: steady-state throughput. Per op, STREAMS batches are launched
back to back and then drained; the host clock covers every launch's host
work (encode, CSPRNG, digit schedules), every copy and every kernel, and
ends in torch.cuda.synchronize (or, for decrypt, in the host finish that
copies the result). Kernel launches are asynchronous, so the host work of
batch i+1 overlaps the device work of batch i. ``warmup`` passes first
(kernel build and per-key constants), then the median of ``runs``
streamed runs.

Parity gates: every run first re-proves bit-exactness of the measured op
surface on the card (pinned-r encrypt against the host's raw_encrypt, add
against the host's c1 c2 mod n^2, aligned add, mixed-sign scalar multiply,
matvec against mul + sum, the decrypt round trip) before any number is
reported. A failed gate raises; nothing retries.

Run on the card:  python -m phe_tpu_torch.bench
"""

import json
import time

import numpy as np
import torch

from phe_tpu_torch.benchmarks import device_name, fixed_key, op_costs

# The reference's single-core CPython rates at 2048 bits (ops/s).
BASELINES = {
    "encrypt": 9.2,
    "decrypt": 32.7,
    "add": 22218.0,
    "mul": 297.0,
}

# Per-op batch sizes, phe_tpu's bench.py's.
SIZES = {
    "encrypt": 16384,
    "decrypt": 16384,
    "add": 524288,
    "mul": 65536,
}
STREAMS = 4  # batches in flight per timed run


def emit(op, ops_per_s, device, cost=None):
    """One JSON line; speed_of_light = measured / roofline
    (phe_tpu_torch.profiling: measured int32 rates and the int8
    tensor-core peak, max over units) when a cost model is supplied."""
    line = {
        "metric": "paillier_%s_2048_batched" % op,
        "value": round(ops_per_s, 2),
        "unit": "ops/s",
        "vs_baseline": round(ops_per_s / BASELINES[op], 2),
        "device": device_name(device),
    }
    if cost is not None:
        from phe_tpu_torch import profiling

        rep = profiling.report(op, ops_per_s, cost)
        line["speed_of_light"] = rep["speed_of_light_fraction"]
        line["bound_by"] = rep["bound_by"]
    print(json.dumps(line), flush=True)
    return line


def _gate(ok, what):
    if not ok:
        raise RuntimeError("parity gate failed: " + what)


def parity_gates(pub, priv, device):
    """Bit-exactness of the whole measured op surface on ``device``."""
    from phe_tpu_torch.batch import EncryptedBatch
    from phe_tpu_torch.encoding import EncodedNumber

    nsq = pub.nsquare
    # 1. Pinned-r encrypt == host-integer raw encryption.
    ms = [1, 2, 10100, pub.n - 1]
    rs = [3, 7, 12345, pub.n - 2]
    enc = EncryptedBatch.encrypt(
        pub, [EncodedNumber(pub, m, 0) for m in ms], r_values=rs,
        device=device,
    )
    got = enc.ciphertext_ints(be_secure=False)
    want = [pub.raw_encrypt(m, r_value=r) for m, r in zip(ms, rs)]
    _gate(got == want, "device/host encrypt")

    # 2a. add at equal exponents: ciphertext product == host mulmod.
    ea = EncryptedBatch.encrypt(pub, [3, -7, 1000, 42], device=device)
    eb = EncryptedBatch.encrypt(pub, [5, 2, -999, 1], device=device)
    got = (ea + eb).ciphertext_ints(be_secure=False)
    want = [
        x * y % nsq
        for x, y in zip(
            ea.ciphertext_ints(be_secure=False),
            eb.ciphertext_ints(be_secure=False),
        )
    ]
    _gate(got == want, "device add")
    # 2b. add with exponent alignment (floats at different exponents).
    vals_a = [1.5, -2.0, 300.0, 0.0625]
    vals_b = [2.5, 7.0, -1.0, 4.0]
    a = EncryptedBatch.encrypt(pub, vals_a, device=device)
    b = EncryptedBatch.encrypt(pub, vals_b, device=device)
    _gate((a + b).decrypt(priv) == [x + y for x, y in zip(vals_a, vals_b)],
          "add decrypt")

    # 3. mul with mixed signs (per-element-exponent pow + inverse trick).
    scal = [3.0, -0.5, 2.0, -16.0]
    _gate((a * scal).decrypt(priv) == [x * y for x, y in zip(vals_a, scal)],
          "device mul")

    # 4. matvec == mul_scalars + sum on a mixed-sign matrix, exactly.
    X = np.array([[1.0, -2.0, 0.5, 3.0], [-1.5, 4.0, -0.25, 2.0]])
    got = a.matvec(X).decrypt(priv)
    want = [
        a.mul_scalars([float(v) for v in row]).sum().decrypt(priv)[0]
        for row in X
    ]
    _gate(got == want, "device matvec")

    # 5. decrypt roundtrip (the timed decrypt re-proves this at scale).
    _gate(a.decrypt(priv) == vals_a, "device decrypt")


def main(runs=5, warmup=2):
    """Parity gates, then the four streamed rates; returns {op: JSON line}.

    runs / warmup: timed and untimed streamed passes per op (5 and 2, as
    phe_tpu's bench.py runs them).
    """
    from phe_tpu_torch.batch import EncryptedBatch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: the "
                           "benchmark needs an NVIDIA GPU")
    dev = torch.device("cuda")
    pub, priv = fixed_key(2048)
    parity_gates(pub, priv, dev)
    costs = op_costs(pub, priv, dev)

    rng = np.random.default_rng(12345)

    def sync(batch):
        torch.cuda.synchronize(batch.mont.device)

    def stream(launch, finish, batch):
        """Steady-state throughput: STREAMS launches, then drain in order.

        launch() does one batch's host work and launches its kernels
        (asynchronous); finish(handle) waits for that batch's result. The
        division by the full wall clock charges every cost: nothing is
        subtracted, overlap is the only effect measured.
        """
        for _ in range(warmup):
            finish(launch())
        ts = []
        for _ in range(runs):
            t0 = time.perf_counter()
            handles = [launch() for _ in range(STREAMS)]
            for h in handles:
                finish(h)
            ts.append(time.perf_counter() - t0)
        return STREAMS * batch / sorted(ts)[len(ts) // 2]

    out = {}
    # -- encrypt (fresh: encode, CSPRNG r, (n*m+1)*r^n mod n^2) ----------
    B = SIZES["encrypt"]
    vals = [float(v) for v in rng.uniform(-1e6, 1e6, B)]
    out["encrypt"] = emit("encrypt", stream(
        lambda: EncryptedBatch.encrypt(pub, vals, device=dev), sync, B
    ), dev, costs["encrypt"])

    # -- decrypt (CRT, full device pipeline, compact host decode) --------
    B = SIZES["decrypt"]
    vals = [float(v) for v in rng.uniform(-1e6, 1e6, B)]
    ct = EncryptedBatch.encrypt(pub, vals, device=dev)
    _gate(ct.decrypt(priv) == vals, "device decrypt at scale")
    out["decrypt"] = emit("decrypt", stream(
        lambda: ct.decrypt_async(priv), lambda fin: fin(), B
    ), dev, costs["decrypt"])

    # -- add enc+enc (aligned exponents: one Montgomery multiply) --------
    B = SIZES["add"]
    vals = [float(v) for v in rng.uniform(-1e6, 1e6, B)]
    ct = EncryptedBatch.encrypt(pub, vals, device=dev)
    ct2 = EncryptedBatch.encrypt(pub, vals, device=dev)
    out["add"] = emit("add", stream(lambda: ct + ct2, sync, B), dev,
                      costs["add"])

    # -- mul enc x float scalar (short-exponent modexp, inverse trick) ---
    B = SIZES["mul"]
    vals = [float(v) for v in rng.uniform(-1e6, 1e6, B)]
    ct = EncryptedBatch.encrypt(pub, vals, device=dev)
    scalars = [float(v) for v in rng.uniform(-100.0, 100.0, B)]
    out["mul"] = emit("mul", stream(
        lambda: ct.mul_scalars(scalars), sync, B
    ), dev, costs["mul"])
    return out


if __name__ == "__main__":
    main()
