"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with ``ctypes`` — no PyTorch headers,
so a build takes seconds. Libraries are built at first use, from the
package's own sources only, into ``config.build_dir()``, under a name that
carries the hash of the source, the shared headers (``csrc/*.cuh``) and
the flags: a changed source or header rebuilds. A failed build raises with
the compiler's output; nothing falls back.

``build_all`` starts one ``nvcc`` per source at once and waits for all of
them, so a cold start costs the slowest build, not the sum.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

from phe_tpu_torch import config

SOURCES = ("mont_mul", "mont_pow", "rns_ladder", "microbench")
_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_BUILD_TIMEOUT_S = 600

_loaded = {}


def _nvcc():
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _paths(name):
    """(source path, library path, log path) for one kernel source."""
    src = os.path.join(_CSRC, name + ".cu")
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(_CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    tag = digest.hexdigest()[:16]
    out = os.path.join(config.build_dir(), "%s-%s" % (name, tag))
    return src, out + ".so", out + ".log"


def _start(name):
    """Start nvcc for one source unless its library exists; (proc, paths)."""
    src, so, log = _paths(name)
    if os.path.exists(so):
        return None, (src, so, log)
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = "%s.tmp.%d" % (so, os.getpid())
    proc = subprocess.Popen(
        [_nvcc(), *_FLAGS, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, (src, so, log)


def _finish(name, proc, paths):
    src, so, log = paths
    if proc is None:
        return
    tmp = "%s.tmp.%d" % (so, os.getpid())
    try:
        output, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log, "w") as f:
        f.write(output)
    if proc.returncode != 0:
        raise RuntimeError(
            "nvcc failed to build %s (exit %d):\n%s"
            % (src, proc.returncode, output)
        )
    os.replace(tmp, so)


def build_all():
    """Compile every kernel source in parallel; return {name: ptxas log}."""
    started = [(name, *_start(name)) for name in SOURCES]
    errors = []
    for name, proc, paths in started:
        try:
            _finish(name, proc, paths)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n\n".join(errors))
    logs = {}
    for name in SOURCES:
        _, _, log = _paths(name)
        with open(log) as f:
            logs[name] = f.read()
    return logs


def load(name):
    """The ctypes library of one kernel source, built at first use."""
    if name not in _loaded:
        proc, paths = _start(name)
        _finish(name, proc, paths)
        _loaded[name] = ctypes.CDLL(paths[1])
    return _loaded[name]


def stream_handle(device):
    """PyTorch's current CUDA stream on device, as a ctypes pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
