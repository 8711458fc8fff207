"""Package metadata."""

__title__ = "phe_tpu_torch"
__version__ = "0.1.0"
__summary__ = (
    "Paillier partially homomorphic encryption on NVIDIA GPUs: the "
    "PyTorch/CUDA port of phe_tpu, batched big-integer Montgomery and RNS "
    "arithmetic as hand-written CUDA kernels."
)
__license__ = "GPLv3"
