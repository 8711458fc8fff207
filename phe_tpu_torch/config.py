"""Runtime configuration: the device and the build directories, in one
place.

The counterpart of phe_tpu/config.py. Its settings are a frozen dataclass
resolved from the environment on every call (``current()``), so tests can
set a variable and the next call sees it; this module is the only one of
the package that reads the environment (``ops/_build.py``'s ``CUDA_HOME``,
which finds the compiler, aside). The variables are the port's own, so
that a process holding both packages sets them apart:

  PHE_TPU_TORCH_CACHE_DIR  where the CUDA kernel libraries are compiled to
                           (default ``build/kernels`` in the checkout, which
                           ``.gitignore`` lists). The build is keyed by the
                           hash of its sources and flags and always cached,
                           so there is no ``enable_persistent_cache``.
  PHE_TPU_TORCH_NATIVE_DIR where the native host engine's library is
                           compiled to (default ``build/native``).

No setting chooses an engine or a REDC body: each is decided from shape,
the modexp engine by ``rns.fits`` (the contexts' ``rns_state()`` in
batch.py) and the limb kernels' REDC body by ``cuda_modexp._body``.
phe_tpu's ``backend`` and ``rns_kernel`` (Pallas or XLA) have no
counterpart either: on the card every wrapper launches its CUDA kernel,
and nothing swaps in the plain PyTorch version.

The device is ``"cuda"`` unless the caller passes another
(``resolve_device``). Asking for CUDA on a machine without it raises;
nothing falls back to the CPU. The CPU is used only when the caller asks
for it (the tests do), and then every kernel wrapper takes its plain
PyTorch version. ``to_device`` moves a host array onto the device, as
every batch program's per-call data arrives there.
"""

import dataclasses
import os

import numpy as np
import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_PKG_DIR), "build")


@dataclasses.dataclass(frozen=True)
class Config:
    """Configuration snapshot (see the module docstring)."""

    cache_dir: str = os.path.join(_BUILD, "kernels")
    native_dir: str = os.path.join(_BUILD, "native")


def current():
    """The configuration as of this call (the environment re-read)."""
    return Config(cache_dir=build_dir(), native_dir=native_dir())


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
    """Directory the CUDA kernel libraries are compiled into
    (PHE_TPU_TORCH_CACHE_DIR)."""
    return os.environ.get("PHE_TPU_TORCH_CACHE_DIR", Config.cache_dir)


def native_dir():
    """Directory the native host engine's library is compiled into
    (PHE_TPU_TORCH_NATIVE_DIR)."""
    return os.environ.get("PHE_TPU_TORCH_NATIVE_DIR", Config.native_dir)
