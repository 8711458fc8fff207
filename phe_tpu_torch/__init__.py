"""phe_tpu_torch: the PyTorch/CUDA port of phe_tpu, a Paillier framework.

The scalar API mirrors phe_tpu's (and the reference ``phe`` package's):
keys, EncodedNumber and EncryptedNumber on host integers. The batch API,
:class:`EncryptedBatch`, keeps ciphertexts as Montgomery limb tensors on an
NVIDIA GPU, with the Montgomery product and the RNS exponentiation ladder
as hand-written CUDA kernels (phe_tpu_torch/csrc). This slice covers the
batched encrypt -> secure export -> decrypt round trip.
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
