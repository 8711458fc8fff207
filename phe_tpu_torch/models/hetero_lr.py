"""Vertical federated logistic regression: Hardy et al.'s masked gradient.

Hardy et al., "Private federated learning on vertically partitioned data
via entity resolution and additively homomorphic encryption",
arXiv:1711.10677, Algorithm 3, in the form FATE's HeteroLR deploys it.
Three parties share the rows of one data set, matched by entity
resolution beforehand: the arbiter holds the key pair; the host holds
some of the features; the guest holds the others (the intercept's
always-one column among them) and the labels y in {-1, +1}. With u = X
theta, the Taylor approximation of the logistic loss's gradient is the
mean of d x over the rows, d = 0.25 u - 0.5 y. One step over a batch of
rows (``train_step``):

1. the host encrypts [[u_A]] = [[X_A theta_A]], one fresh ciphertext a row;
2. the guest forms [[d]] = 0.25 [[u_A]] + (0.25 u_B - 0.5 y): one
   ``mul_scalars`` by the shared scalar, one ``add_scalars``;
3. each party computes its encrypted gradient [[g]] = X^T [[d]] in one
   ``EncryptedBatch.matvec``: a [features, rows] grid of exponents,
   negative features on the batch-inverted [[d]], run as a shared-table
   multi-exponentiation (each row's 16-row table of [[d_i]] and of its
   inverse built once, one product tree over the rows a feature and
   window, Horner a feature);
4. each party masks its gradient with random plaintexts (``add_scalars``);
5. the arbiter decrypts the masked coordinates only; each party unmasks
   its own and divides by the rows.

The arbiter sees masked sums, the guest [[u_A]] encrypted, and the host
nothing of the labels. The loss itself (a second encryption of the rows
in Hardy et al.) is not computed here.
"""

import contextlib
from typing import NamedTuple

import numpy as np

from phe_tpu_torch.batch import EncryptedBatch

QUARTER, HALF = 0.25, 0.5


class Arbiter:
    """The key holder: decrypts masked gradients and nothing else."""

    def __init__(self, public_key, private_key):
        self.public_key = public_key
        self.private_key = private_key

    def decrypt(self, masked):
        return masked.decrypt(self.private_key)


class Host:
    """A party holding features only: X [rows, features], float64."""

    def __init__(self, public_key, X, device=None):
        self.public_key = public_key
        self.X = np.asarray(X, dtype=np.float64)
        self.device = device

    def scores(self, theta):
        return self.X @ np.asarray(theta, dtype=np.float64)

    def encrypted_scores(self, theta, obfuscation="exact"):
        """[[X theta]]: one fresh encryption a row."""
        return EncryptedBatch.encrypt(self.public_key,
                                      self.scores(theta).tolist(),
                                      obfuscation=obfuscation,
                                      device=self.device)

    def encrypted_gradient(self, d):
        """X^T [[d]]: one encrypted coordinate a feature."""
        return d.matvec(self.X.T)


class Guest(Host):
    """A party holding features and the labels y in {-1, +1}."""

    def __init__(self, public_key, X, y, device=None):
        super().__init__(public_key, X, device)
        self.y = np.asarray(y, dtype=np.float64)

    def residual(self, u_host, theta):
        """[[d]] = 0.25 [[u_A]] + (0.25 u_B - 0.5 y)."""
        scalars = QUARTER * self.scores(theta) - HALF * self.y
        return u_host.mul_scalars(QUARTER).add_scalars(scalars.tolist())


class StepResult(NamedTuple):
    """What one step produced: [[u_A]], [[d]], each party's masked
    encrypted gradient, the masked coordinates as the arbiter decrypted
    them, and each party's unmasked gradient."""

    u_host: EncryptedBatch
    d: EncryptedBatch
    masked_host: EncryptedBatch
    masked_guest: EncryptedBatch
    plain_host: list
    plain_guest: list
    gradient_host: np.ndarray
    gradient_guest: np.ndarray


def train_step(arbiter, host, guest, theta_host, theta_guest, mask_host,
               mask_guest, obfuscation="exact", phase=None):
    """One step of Algorithm 3 over the parties' rows (steps 1-5 above).

    mask_host, mask_guest: one plaintext a feature of each party.
    obfuscation: the host's encryption of [[u_A]], as
    ``EncryptedBatch.encrypt`` takes it. phase: None, or a callable
    giving a context manager for each of "encrypt", "residual",
    "gradient" and "decrypt", entered around that part of the step.
    """
    phase = phase or (lambda name: contextlib.nullcontext())
    rows = len(guest.y)
    with phase("encrypt"):
        u_host = host.encrypted_scores(theta_host, obfuscation)
    with phase("residual"):
        d = guest.residual(u_host, theta_guest)
    mask_host = np.asarray(mask_host, dtype=np.float64)
    mask_guest = np.asarray(mask_guest, dtype=np.float64)
    with phase("gradient"):
        masked_host = host.encrypted_gradient(d).add_scalars(
            mask_host.tolist())
        masked_guest = guest.encrypted_gradient(d).add_scalars(
            mask_guest.tolist())
    with phase("decrypt"):
        plain_host = arbiter.decrypt(masked_host)
        plain_guest = arbiter.decrypt(masked_guest)
    return StepResult(
        u_host, d, masked_host, masked_guest, plain_host, plain_guest,
        (np.asarray(plain_host, dtype=np.float64) - mask_host) / rows,
        (np.asarray(plain_guest, dtype=np.float64) - mask_guest) / rows)
