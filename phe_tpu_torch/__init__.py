"""phe_tpu_torch: the PyTorch/CUDA port of phe_tpu, a Paillier framework.

The scalar API mirrors phe_tpu's (and the reference ``phe`` package's):
keys, EncodedNumber and EncryptedNumber on host integers. The batch API,
:class:`EncryptedBatch`, keeps ciphertexts as Montgomery limb tensors on an
NVIDIA GPU, with the Montgomery product, the RNS exponentiation ladder
(shared or per-element exponent) and the limb-engine windowed modexps as
hand-written CUDA kernels (phe_tpu_torch/csrc). The port covers encryption
(exact, short or no obfuscation), secure export, decryption, and the
homomorphic algebra (add, subtract, scalar multiply, exponent alignment,
sum, dot, matvec), with the two applications of
:mod:`phe_tpu_torch.models` on top; the JWK and ciphertext wire formats
(:mod:`~phe_tpu_torch.serial`, :mod:`~phe_tpu_torch.util`) and the
pheutil CLI (``python -m phe_tpu_torch.cli``); the aggregation reduce
over ranks on torch.distributed (:mod:`~phe_tpu_torch.parallel`); and the
native C++ host engine behind ``utils.ntheory`` (``HAVE_NATIVE``).

Two modexp engines serve every key size, chosen as phe_tpu chooses them
by default: the RNS ladder where the channel-prime supply covers the
modulus (``rns.fits``, up to ~8,760 bits: n^2 of keys up to ~4,380 bits,
and the decrypt halves p^2, q^2 of keys up to ~8,760 bits), and the limb
engine's windowed modexps past it (n^2 of an 8192-bit key, for one). The
limb kernels reduce on the int8 tensor cores or on the integer pipe,
whichever ``cuda_modexp._body`` picks at each launch's shape.
:mod:`~phe_tpu_torch.profiling`,
:mod:`~phe_tpu_torch.benchmarks`, :mod:`~phe_tpu_torch.bench` and
:mod:`~phe_tpu_torch.microbench` measure them on the card.
"""

from phe_tpu_torch.batch import EncryptedBatch
from phe_tpu_torch.encoding import EncodedNumber
from phe_tpu_torch.encrypted import EncryptedNumber
from phe_tpu_torch.keys import (
    DEFAULT_KEYSIZE,
    PaillierPrivateKey,
    PaillierPrivateKeyring,
    PaillierPublicKey,
    generate_paillier_keypair,
)

__all__ = [
    "EncodedNumber",
    "EncryptedBatch",
    "EncryptedNumber",
    "PaillierPrivateKey",
    "PaillierPrivateKeyring",
    "PaillierPublicKey",
    "generate_paillier_keypair",
    "DEFAULT_KEYSIZE",
]
