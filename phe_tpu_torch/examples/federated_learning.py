"""Federated learning with encrypted gradient aggregation, batch-first.

The reference's flagship example
(reference: examples/federated_learning_with_encryption.py): five
"hospitals" train a shared linear model on the sklearn diabetes dataset
without revealing their data; each round every client encrypts its local
gradient under the server's public key, the encrypted gradients are summed
homomorphically, and the server decrypts only the aggregate.

Where the reference passes scalar EncryptedNumber objects around a Python
ring (:213-225), here each client's gradient is one batch on the card and
the C-way sum is a log-depth Montgomery-product tree, or, with --mesh, the
sharded reduce of phe_tpu_torch.parallel over the ranks of the process
group (a world of one in a single process).

Run:  python -m phe_tpu_torch.examples.federated_learning [--clients 5]
      [--iters 20] [--key-length 1024] [--mesh] [--device cpu]
"""

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--key-length", type=int, default=1024)
    ap.add_argument("--mesh", action="store_true",
                    help="shard the aggregation over the process group's "
                         "ranks")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the batches (default: cuda)")
    args = ap.parse_args(argv)

    from phe_tpu_torch.models.federated import run_federated_learning

    mesh = None
    if args.mesh:
        from phe_tpu_torch.parallel import batch_mesh

        mesh = batch_mesh()

    t0 = time.perf_counter()
    result = run_federated_learning(
        n_clients=args.clients,
        n_iter=args.iters,
        key_length=args.key_length,
        mesh=mesh,
        device=args.device,
    )
    dt = time.perf_counter() - t0
    print("MSE trajectory: %s" % ["%.4f" % m for m in result["mse"]])
    print("total runtime: %.2f s on %s (reference with gmpy2: ~4.5 s, "
          "pure python: ~35.7 s; README.rst:52-56)" % (dt, args.device))
    return result


if __name__ == "__main__":
    main()
