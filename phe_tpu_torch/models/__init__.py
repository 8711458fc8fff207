"""Model families: privacy-preserving ML protocols on the batch engine.

The PyTorch counterparts of phe_tpu.models, encrypted logistic-regression
scoring and federated gradient aggregation, and vertical federated
logistic regression (Hardy et al.'s masked gradient, hetero_lr), built on
EncryptedBatch.
"""

from phe_tpu_torch.models.federated import (
    FederatedClient,
    FederatedServer,
    aggregate_encrypted_gradients,
    run_federated_learning,
)
from phe_tpu_torch.models.hetero_lr import Arbiter, Guest, Host, train_step
from phe_tpu_torch.models.logreg import EncryptedScorer, train_spam_classifier

__all__ = [
    "FederatedClient",
    "FederatedServer",
    "aggregate_encrypted_gradients",
    "run_federated_learning",
    "EncryptedScorer",
    "train_spam_classifier",
    "Arbiter",
    "Guest",
    "Host",
    "train_step",
]
