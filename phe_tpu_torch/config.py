"""Runtime configuration: the device and the kernel build directory.

The port has two modexp engines, the RNS ladder and the limb engine's
windowed modexps, each with its CUDA kernels. There is no knob between
them: the RNS ladder runs wherever the channel-prime supply covers the
modulus and the limb engine past it, decided per modulus by
``rns_state()`` in phe_tpu_torch.batch. What remains to configure is where
tensors live and where the hand-written kernels are compiled to:

  device        ``"cuda"`` unless the caller passes another. Asking for
                CUDA on a machine without it raises; nothing falls back to
                the CPU. The CPU is used only when the caller asks for it
                (the tests do), and then every kernel wrapper takes its
                plain PyTorch version.
  build_dir()   ``build/kernels`` in the checkout that holds the package,
                which ``.gitignore`` lists: the compiled kernel libraries.
  native_dir()  ``build/native`` beside it: the native host engine's
                library (phe_tpu_torch.native).

``to_device`` moves a host array onto the device, as every batch
program's per-call data arrives there.
"""

import os

import numpy as np
import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))


def resolve_device(device=None):
    """The torch.device to run on: CUDA unless the caller says otherwise.

    A CUDA device always carries its index, as a tensor's .device does:
    the keys' per-device constants are cached under what this returns
    and looked up again by a batch's tensor device, and "cuda" and
    "cuda:0" are different keys.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(array, device):
    """A host array as a tensor on ``device``.

    To the card through pinned memory, without waiting for the copy: the
    staging buffer stays pinned until the copy has run, and the host goes
    on to the next launch (nothing here reads back, so a batch program's
    inputs arrive without a host wait).
    """
    device = torch.device(device)
    t = torch.as_tensor(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def build_dir():
    """Directory the CUDA kernel libraries are compiled into."""
    return os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")


def native_dir():
    """Directory the native host engine's library is compiled into."""
    return os.path.join(os.path.dirname(_PKG_DIR), "build", "native")
