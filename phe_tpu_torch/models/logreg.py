"""Encrypted-model logistic regression scoring (Alice/Bob protocol).

The counterpart of phe_tpu/models/logreg.py, with the protocol of the
reference example (examples/logistic_regression_encrypted_model.py): Alice
trains a classifier on plaintext and encrypts its coefficients under her
key (:144-149); Bob, who must not learn the model, computes encrypted
scores x.w for his examples (:170-177) and returns them; Alice decrypts
the scores only (:151-152).

Bob's whole example matrix scores in one EncryptedBatch.matvec: a [B, D]
grid of exponents with the alignment fused in, run as a shared-table
multi-exponentiation (each weight's table built once, a log-depth tree of
Montgomery products over the weights for each example and window, Horner
an example). The intercept rides as an extra always-one feature column,
so it stays encrypted too.
"""

import numpy as np

from phe_tpu_torch.batch import EncryptedBatch


def train_spam_classifier(n_samples=600, n_features=20, seed=0):
    """A stand-in for the reference's email corpus (offline environment):
    synthetic binary classification + sklearn logistic regression. sklearn
    is imported here, so the module loads where it is not installed."""
    from sklearn.datasets import make_classification
    from sklearn.linear_model import LogisticRegression
    from sklearn.model_selection import train_test_split

    X, y = make_classification(
        n_samples=n_samples,
        n_features=n_features,
        n_informative=n_features // 2,
        random_state=seed,
    )
    X_train, X_test, y_train, y_test = train_test_split(
        X, y, random_state=seed
    )
    model = LogisticRegression(max_iter=1000).fit(X_train, y_train)
    return model, X_test, y_test


class EncryptedScorer:
    """Bob's view: a public key and encrypted (coef, intercept) weights."""

    def __init__(self, public_key, encrypted_weights):
        self.public_key = public_key
        self.weights = encrypted_weights  # EncryptedBatch, length D+1

    @classmethod
    def from_model(cls, public_key, coef, intercept, device=None):
        """Alice encrypts her trained model (reference :144-149) on
        ``device`` (None for CUDA, "cpu" for the plain versions)."""
        weights = [float(w) for w in np.ravel(coef)] + [float(intercept)]
        return cls(public_key,
                   EncryptedBatch.encrypt(public_key, weights, device=device))

    def encrypted_scores(self, X):
        """Encrypted x.w + b for every row of X (reference :170-177)."""
        X = np.asarray(X, dtype=np.float64)
        ones = np.ones((X.shape[0], 1))
        return self.weights.matvec(np.hstack([X, ones]))


def score_roundtrip(private_key, scorer, X):
    """Alice-side decryption of Bob's encrypted scores -> probabilities."""
    scores = np.asarray(scorer.encrypted_scores(X).decrypt(private_key))
    return 1.0 / (1.0 + np.exp(-scores))
