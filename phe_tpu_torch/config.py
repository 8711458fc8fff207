"""Runtime configuration: the device and the kernel build directory.

The port has one modexp engine (RNS, with its ladder as a CUDA kernel), so
there is no engine knob. What remains is where tensors live and where the
hand-written kernels are compiled to:

  device        ``"cuda"`` unless the caller passes another. Asking for
                CUDA on a machine without it raises; nothing falls back to
                the CPU. The CPU is used only when the caller asks for it
                (the tests do), and then every kernel wrapper takes its
                plain PyTorch version.
  build_dir()   ``build/kernels`` in the checkout that holds the package,
                which ``.gitignore`` lists: the compiled kernel libraries.
"""

import os

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))


def resolve_device(device=None):
    """The torch.device to run on: CUDA unless the caller says otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def build_dir():
    """Directory the CUDA kernel libraries are compiled into."""
    return os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
