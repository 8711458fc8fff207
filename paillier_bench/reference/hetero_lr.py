"""One step of vertical federated logistic regression in python-paillier's
exact encoded arithmetic: the yardstick of the ``vfl_hetero_lr`` mix.

Python integers and NumPy only, on ``paillier.py``'s encode, aligned sums
and decode. Nothing here imports jax, phe_tpu or phe_tpu_torch.

Hardy et al., arXiv:1711.10677, Algorithm 3, with labels y in {-1, +1}
and the Taylor approximation of the logistic loss's gradient: host A
holds features X_A, guest B holds X_B and y, and with u = X theta the
residual is d = 0.25 u - 0.5 y, split as 0.25 [[u_A]] + (0.25 u_B -
0.5 y). Each party's gradient is X^T d over the batch's rows, masked
with a random plaintext before the key holder decrypts it, then
unmasked and divided by the rows. Every operation is python-paillier's
on EncryptedNumber:

* ``u_A``'s encoding (``EncryptedNumber.encrypt``);
* times 0.25: the product of the mantissas at the sum of the exponents
  (``__mul__``, phe/paillier.py:721-751);
* plus the scalar 0.25 u_B - 0.5 y, encoded at max_exponent = [[0.25
  u_A]]'s exponent and the two brought to the smaller exponent
  (``_add_scalar``, :640-675);
* X^T [[d]]: each [[d_j]] times each x_ij's encoding, summed over the
  rows at the least exponent (``__add__``'s alignment, :664-669);
* plus each mask, encoded at max_exponent = the sum's exponent; decode.

All of it is exact integer arithmetic, so the decoded masked gradients
are the one correctly rounded float of each exact sum.
"""

from typing import NamedTuple

import numpy as np

from paillier_bench.reference.paillier import (
    LOG2_BASE, aligned_sums, decode, encode, encode_array)

QUARTER, HALF = 0.25, 0.5


class Gradient(NamedTuple):
    """One party's gradient: the exact masked sums (signed mantissas as
    Python ints, and their exponents), the decoded masked floats, and
    the unmasked gradient."""

    totals: list
    exponents: np.ndarray
    masked: list
    gradient: np.ndarray


class Step(NamedTuple):
    """One step: [[u_A]]'s and [[d]]'s encodings (mantissas as an object
    array of Python ints, exponents int64), and each party's Gradient."""

    u_mantissas: np.ndarray
    u_exponents: np.ndarray
    d_mantissas: np.ndarray
    d_exponents: np.ndarray
    host: Gradient
    guest: Gradient


def encode_at_most(values, max_exponents):
    """encode_array at exponents no higher than max_exponents
    (EncodedNumber.encode's max_exponent): the natural encoding scaled
    down exactly by BASE ** diff where it lies above. Object mantissas."""
    mant, exps = encode_array(values)
    target = np.minimum(exps, max_exponents)
    shifts = (LOG2_BASE * (exps - target)).astype(object)
    return mant.astype(object) << shifts, target


def scores(X, theta):
    """u = X theta, as every party computes it (float64 NumPy)."""
    return np.asarray(X, dtype=np.float64) @ np.asarray(theta,
                                                        dtype=np.float64)


def guest_scalars(X_guest, theta_guest, y):
    """0.25 u_B - 0.5 y, the plaintext the guest adds to 0.25 [[u_A]]."""
    return QUARTER * scores(X_guest, theta_guest) - HALF * np.asarray(
        y, dtype=np.float64)


def residual(u_host, scalars):
    """[[d]]'s encoding: (object mantissas, int64 exponents)."""
    mu, eu = encode_array(u_host)
    mq, eq = encode(QUARTER)
    m, e = mu.astype(object) * mq, eu + eq
    ms, es = encode_at_most(scalars, e)
    # es <= e: the product is brought down to the scalar's exponent.
    return (m << (LOG2_BASE * (e - es)).astype(object)) + ms, es


def gradient(d_mant, d_exps, X, masks, rows):
    """X^T [[d]] plus the masks, decoded, and the gradient unmasked."""
    mx, ex = encode_array(np.asarray(X, dtype=np.float64))
    totals = aligned_sums(d_mant[:, None] * mx, d_exps[:, None] + ex)
    exps = (d_exps[:, None] + ex).min(axis=0)
    masks = np.asarray(masks, dtype=np.float64)
    mm, em = encode_at_most(masks, exps)
    # em <= exps: each sum is brought down to its mask's exponent.
    out = [(t << (LOG2_BASE * int(e - f))) + int(m)
           for t, e, f, m in zip(totals, exps, em, mm)]
    masked = [decode(t, int(f)) for t, f in zip(out, em)]
    unmasked = (np.asarray(masked, dtype=np.float64) - masks) / rows
    return Gradient(out, em, masked, unmasked)


def step(X_host, X_guest, y, theta_host, theta_guest, mask_host,
         mask_guest):
    """One step of Algorithm 3 over the batch's rows."""
    rows = len(y)
    u = scores(X_host, theta_host)
    mu, eu = encode_array(u)
    d_mant, d_exps = residual(u, guest_scalars(X_guest, theta_guest, y))
    return Step(mu.astype(object), eu, d_mant, d_exps,
                gradient(d_mant, d_exps, X_host, mask_host, rows),
                gradient(d_mant, d_exps, X_guest, mask_guest, rows))
