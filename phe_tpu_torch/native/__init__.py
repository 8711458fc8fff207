"""Native host bignum backend: a C++ Montgomery engine built at first import.

The port's copy of phe_tpu's native engine, playing the role gmpy2 plays
for the reference (phe/util.py:21-25 import-time feature detection): if a
C++ toolchain is available, ``bigmath.cpp`` is compiled once with
``g++ -O3 -shared -fPIC`` into ``config.native_dir()`` (``build/native``
in the checkout, which ``.gitignore`` lists) under a name that carries the
source's hash, and loaded with ctypes; otherwise ``HAVE_NATIVE`` is False
and callers (phe_tpu_torch.utils.ntheory) use CPython's built-in pow: the
same contract as the reference's HAVE_GMP/HAVE_CRYPTO flags. This is host
code for one-off scalar calls (key generation's Miller-Rabin witnesses,
the scalar API's modexps); the batched path runs on the card.

Exposed helpers operate on Python ints and handle the limb packing:
  powmod(a, b, c)          -- c odd, within capacity; else raises ValueError
  miller_rabin_native(n, witnesses) -- batched witness checks on odd n
"""

import ctypes
import hashlib
import os
import subprocess

from phe_tpu_torch import config

HAVE_NATIVE = False
MAX_MODULUS_BITS = 8192
_lib = None

_SRC = os.path.join(os.path.dirname(__file__), "bigmath.cpp")
_BUILD_TIMEOUT_S = 120


def _build_and_load():
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    so_path = os.path.join(config.native_dir(), "bigmath-%s.so" % tag)
    if not os.path.exists(so_path):
        os.makedirs(os.path.dirname(so_path), exist_ok=True)
        tmp = "%s.tmp.%d" % (so_path, os.getpid())
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
            timeout=_BUILD_TIMEOUT_S,
        )
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    lib.phe_powmod.restype = ctypes.c_int
    lib.phe_powmod.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.phe_miller_rabin.restype = ctypes.c_int
    lib.phe_miller_rabin.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int,
    ]
    return lib


try:
    _lib = _build_and_load()
    HAVE_NATIVE = True
except (OSError, subprocess.SubprocessError):
    # No toolchain (FileNotFoundError), a failed or timed-out build, or a
    # library that does not load: the pure-CPython path serves instead.
    _lib = None
    HAVE_NATIVE = False


def _pack(value, limbs):
    arr = (ctypes.c_uint64 * limbs)()
    ctypes.memmove(arr, value.to_bytes(limbs * 8, "little"), limbs * 8)
    return arr


def _unpack(arr, limbs):
    return int.from_bytes(bytes(arr)[: limbs * 8], "little")


def powmod(a, b, c):
    """a**b mod c through the native engine (c odd, <= MAX_MODULUS_BITS)."""
    if _lib is None:
        raise RuntimeError("native backend unavailable")
    if c <= 0 or not (c & 1) or c.bit_length() > MAX_MODULUS_BITS:
        raise ValueError("unsupported modulus for native powmod")
    if b < 0:
        raise ValueError("negative exponent")
    L = (c.bit_length() + 63) // 64
    ne = max(1, (b.bit_length() + 63) // 64)
    out = (ctypes.c_uint64 * L)()
    rc = _lib.phe_powmod(
        _pack(a % c, L), _pack(b, ne), ne, _pack(c, L), L, out
    )
    if rc != 0:
        raise ValueError("native powmod rejected input")
    return _unpack(out, L)


def miller_rabin_native(n, witnesses):
    """True iff odd n > 3 passes Miller-Rabin for every witness given."""
    if _lib is None:
        raise RuntimeError("native backend unavailable")
    if not (n & 1) or n.bit_length() > MAX_MODULUS_BITS:
        raise ValueError("unsupported n for native miller-rabin")
    L = (n.bit_length() + 63) // 64
    k = len(witnesses)
    flat = (ctypes.c_uint64 * (L * k))()
    for i, w in enumerate(witnesses):
        ctypes.memmove(
            ctypes.byref(flat, i * L * 8), (w % n).to_bytes(L * 8, "little"),
            L * 8,
        )
    rc = _lib.phe_miller_rabin(_pack(n, L), L, flat, k)
    if rc < 0:
        raise ValueError("native miller-rabin rejected input")
    return bool(rc)
