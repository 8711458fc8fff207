"""Encrypted-model logistic regression scoring (Alice/Bob).

The reference's second example
(reference: examples/logistic_regression_encrypted_model.py): Alice trains
a classifier and encrypts the coefficients under her key; Bob scores his
own examples against the encrypted model, learning nothing about the
weights, and returns encrypted scores that only Alice can decrypt.

The reference scores one example at a time with a powmod per feature
(:170-177); here Bob's whole test matrix scores in one matvec on the card.

Run:  python -m phe_tpu_torch.examples.logistic_regression
      [--key-length 1024] [--examples 64] [--device cpu]
"""

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--key-length", type=int, default=1024)
    ap.add_argument("--examples", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the encrypted model (default: "
                         "cuda)")
    args = ap.parse_args(argv)

    import phe_tpu_torch
    from phe_tpu_torch.models.logreg import (
        EncryptedScorer,
        score_roundtrip,
        train_spam_classifier,
    )

    print("Alice: training the classifier")
    model, X_test, y_test = train_spam_classifier()
    X = X_test[: args.examples]

    print("Alice: generating a %d-bit keypair and encrypting the model"
          % args.key_length)
    pub, priv = phe_tpu_torch.generate_paillier_keypair(
        n_length=args.key_length)
    scorer = EncryptedScorer.from_model(
        pub, model.coef_, model.intercept_[0], device=args.device
    )

    print("Bob: scoring %d examples against the encrypted model" % len(X))
    t0 = time.perf_counter()
    probs = score_roundtrip(priv, scorer, X)
    dt = time.perf_counter() - t0

    pred = (probs > 0.5).astype(int)
    acc = float(np.mean(pred == y_test[: args.examples]))
    plain_probs = model.predict_proba(X)[:, 1]
    agrees = bool(np.allclose(probs, plain_probs, atol=1e-6))
    print("encrypted-score accuracy: %.3f (plaintext model agrees: %s)"
          % (acc, agrees))
    print("scoring time: %.2f s for %d examples on %s"
          % (dt, len(X), args.device))
    return acc, agrees


if __name__ == "__main__":
    main()
