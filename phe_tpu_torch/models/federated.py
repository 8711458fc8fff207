"""Federated linear regression with encrypted gradient aggregation.

The counterpart of phe_tpu/models/federated.py, with the protocol of the
reference example (examples/federated_learning_with_encryption.py): n
hospitals each hold a private slice of a regression dataset; every round
each client computes its local gradient and encrypts it under the
server-issued public key, the encrypted gradients are summed (ciphertext
products), and only the sum is decrypted by the server (privacy model at
:24-60 of the reference example). The C encrypted gradient vectors live as
a [C, D, L] limb tensor and reduce over the client axis in one log-depth
tree of Montgomery products on one device, or over the ranks of a
phe_tpu_torch.parallel mesh when one is given.
"""

import numpy as np
import torch

from phe_tpu_torch.batch import EncryptedBatch, _tree_reduce_dev
from phe_tpu_torch.keys import generate_paillier_keypair


def _sync_gradient(X, y, weights):
    """Mean-squared-error gradient for linear regression (host numpy)."""
    delta = X @ weights - y
    return X.T @ delta / len(X)


def _encode_floats(vec):
    return [float(v) for v in np.asarray(vec).ravel()]


class FederatedClient:
    """One data-holding party (the reference example's Hospital client)."""

    def __init__(self, name, X, y, public_key, device=None):
        self.name = name
        self.X = np.asarray(X, dtype=np.float64)
        self.y = np.asarray(y, dtype=np.float64)
        self.public_key = public_key
        self.device = device
        self.weights = np.zeros(self.X.shape[1])

    def gradient(self):
        return _sync_gradient(self.X, self.y, self.weights)

    def encrypted_gradient(self):
        """Encrypt the local gradient as one device batch."""
        return EncryptedBatch.encrypt(
            self.public_key, _encode_floats(self.gradient()),
            device=self.device,
        )

    def step(self, aggregate_gradient, eta, n_clients):
        """Gradient-descent update from the decrypted aggregate."""
        self.weights -= eta * np.asarray(aggregate_gradient) / n_clients


class FederatedServer:
    """Key-issuing aggregator: sees only the summed gradient."""

    def __init__(self, key_length=1024):
        self.public_key, self._private_key = generate_paillier_keypair(
            n_length=key_length
        )

    def decrypt_aggregate(self, encrypted_batch):
        return encrypted_batch.decrypt(self._private_key)


def aggregate_encrypted_gradients(batches, mesh=None):
    """Sum C encrypted gradient vectors dimension-wise.

    batches: EncryptedBatch objects of one length D on one device.
    Exponents align per dimension to the cross-client minimum (the
    reference's alignment rule, phe/paillier.py:664-669); the C-way
    product then runs as one tree of Montgomery products over the client
    axis, or, with a mesh (phe_tpu_torch.parallel.batch_mesh), sharded
    over its ranks, every rank passing the same batches.
    """
    exp_grid = np.stack([b.exponents for b in batches])  # [C, D]
    target = exp_grid.min(axis=0)
    aligned = [b.decrease_exponent_to(target) for b in batches]
    pub = batches[0].public_key
    dc = batches[0]._dc
    mont = torch.stack([b.mont for b in aligned])  # [C, Dp, L]
    if mesh is not None:
        from phe_tpu_torch.parallel.aggregate import allreduce_mul_mont

        out = allreduce_mul_mont(mont, dc.ctx, mesh, vector_axes=1)
    else:
        out = _tree_reduce_dev(mont, dc.ctx)[0]
    return EncryptedBatch(pub, out, target, False)


def load_diabetes_split(n_clients, seed=42):
    """The reference example's dataset: sklearn diabetes, split per client
    (examples/federated_learning_with_encryption.py:73-103). sklearn is
    imported here, so the module loads where it is not installed."""
    from sklearn.datasets import load_diabetes

    X, y = load_diabetes(return_X_y=True)
    y = (y - y.mean()) / y.std()
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(X))
    X, y = X[perm], y[perm]
    test = len(X) // 5
    X_test, y_test = X[:test], y[:test]
    X_train, y_train = X[test:], y[test:]
    return (
        np.array_split(X_train, n_clients),
        np.array_split(y_train, n_clients),
        X_test,
        y_test,
    )


def run_federated_learning(n_clients=5, n_iter=20, eta=1.5, key_length=1024,
                           mesh=None, data=None, device=None):
    """End-to-end protocol run; returns the test MSE trajectory.

    Mirrors the reference's main loop (its federated_learning settings at
    :254-260: 1024-bit key, 5 clients) with the ring replaced by the
    batched aggregation on ``device``, sharded over ``mesh`` when given.
    """
    if data is None:
        data = load_diabetes_split(n_clients)
    X_parts, y_parts, X_test, y_test = data
    server = FederatedServer(key_length=key_length)
    clients = [
        FederatedClient("client%d" % i, X_parts[i], y_parts[i],
                        server.public_key, device=device)
        for i in range(n_clients)
    ]
    mse = []
    for _ in range(n_iter):
        encrypted = [c.encrypted_gradient() for c in clients]
        aggregate = aggregate_encrypted_gradients(encrypted, mesh=mesh)
        grad_sum = server.decrypt_aggregate(aggregate)
        for c in clients:
            c.step(grad_sum, eta, n_clients)
        pred = X_test @ clients[0].weights
        mse.append(float(np.mean((pred - y_test) ** 2)))
    return {"mse": mse, "weights": clients[0].weights}
