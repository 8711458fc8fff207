"""The port's native host engine (phe_tpu_torch.native) against phe_tpu's.

The port keeps its own copy of bigmath.cpp, built at first import with
g++ into build/native under the source's hash. Its powmod and
miller_rabin_native equal phe_tpu's native engine and CPython's pow on
the same inputs (tests/test_native.py's cases), and the port's ntheory
sends odd moduli from 512 bits to it behind HAVE_NATIVE. With the
library absent (no toolchain: HAVE_NATIVE False, as the reference's
HAVE_GMP) every result still agrees (tests/test_native_off.py). Exact
integer arithmetic: tolerance zero.
"""

import hashlib
import os
import random
import shutil
import subprocess
import sys

import pytest

from phe_tpu import native as jnative

import phe_tpu_torch as pt
from phe_tpu_torch import config, native, util
from phe_tpu_torch.utils import ntheory

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def built():
    if not native.HAVE_NATIVE:
        pytest.skip("no C++ toolchain: the native engine did not build")


def _random_odd(bits, rng):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def test_library_is_keyed_on_the_source_hash(built):
    with open(native._SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(config.native_dir(), "bigmath-%s.so" % tag)
    assert os.path.exists(so)
    assert native._lib._name == so
    assert config.native_dir().endswith(os.path.join("build", "native"))
    assert ntheory.HAVE_NATIVE and util.HAVE_NATIVE


@pytest.mark.parametrize("bits", [512, 768, 1024, 2048, 4096, 8192])
def test_powmod_equals_phe_tpu_and_cpython(built, bits):
    rng = random.Random(bits)
    for _ in range(6 if bits < 4096 else 2):
        c = _random_odd(bits, rng)
        a = rng.randrange(c)
        b = rng.getrandbits(bits)
        want = pow(a, b, c)
        assert native.powmod(a, b, c) == want
        if bits <= jnative.MAX_MODULUS_BITS:
            assert jnative.powmod(a, b, c) == want


def test_powmod_edge_cases(built):
    c = _random_odd(512, random.Random(7))
    assert native.powmod(0, 5, c) == 0
    assert native.powmod(5, 0, c) == 1
    assert native.powmod(0, 0, c) == 1
    assert native.powmod(c + 3, 2, c) == pow(c + 3, 2, c)
    assert native.powmod(c - 1, c - 1, c) == pow(c - 1, c - 1, c)
    for bad in ((2, 3, 1 << 600), (2, 3, (1 << 8193) + 1), (2, -1, c)):
        with pytest.raises(ValueError):
            native.powmod(*bad)


def test_miller_rabin_equals_phe_tpu(built):
    rng = random.Random(99)
    m521 = (1 << 521) - 1  # a Mersenne prime
    p = pt.utils.getprimeover(300)
    q = pt.utils.getprimeover(300)
    for n, want in ((m521, True), (m521 * ((1 << 607) - 1), False),
                    (p * q, False), (p, True)):
        ws = [rng.randrange(2, n - 2) for _ in range(8)]
        assert native.miller_rabin_native(n, ws) is want
        assert jnative.miller_rabin_native(n, ws) is want
    with pytest.raises(ValueError):
        native.miller_rabin_native(1 << 600, [3])


def test_ntheory_dispatch_agrees_with_cpython(built, monkeypatch):
    rng = random.Random(5)
    c = _random_odd(1024, rng)
    a, b = rng.randrange(c), rng.getrandbits(1024)
    calls = []
    real = native.powmod
    monkeypatch.setattr(native, "powmod",
                        lambda *args: calls.append(args) or real(*args))
    assert ntheory.powmod(a, b, c) == pow(a, b, c)
    assert len(calls) == 1
    # Below 512 bits, even moduli and negative exponents take CPython's pow.
    small = _random_odd(128, rng)
    assert ntheory.powmod(a % small, b, small) == pow(a, b, small)
    assert ntheory.powmod(a, b, c + 1) == pow(a, b, c + 1)
    assert ntheory.powmod(3, -1, c) == pow(3, -1, c)
    assert len(calls) == 1
    assert ntheory.is_prime((1 << 521) - 1)
    assert not ntheory.is_prime(((1 << 521) - 1) * ((1 << 607) - 1))


@pytest.mark.parametrize("bits", [512, 1024])
def test_keygen_on_the_native_engine_round_trips(built, bits):
    pub, priv = pt.generate_paillier_keypair(n_length=bits)
    assert pub.n.bit_length() == bits
    enc = pub.encrypt(42.5)
    assert priv.decrypt(enc) == 42.5
    assert priv.decrypt(enc * -3 + 1) == -126.5


def test_forced_off_dispatch_agrees(monkeypatch):
    a, b = 2**2000 + 12345, 2**1024 + 7
    c = 2**2048 - 159
    with_native = ntheory.powmod(a, b, c)
    monkeypatch.setattr(ntheory, "HAVE_NATIVE", False)
    monkeypatch.setattr(native, "powmod", None)  # never reached
    monkeypatch.setattr(native, "miller_rabin_native", None)
    assert ntheory.powmod(a, b, c) == with_native == pow(a, b, c)
    assert ntheory.is_prime((1 << 521) - 1)
    assert not ntheory.is_prime(((1 << 521) - 1) * ((1 << 607) - 1))
    p = ntheory.getprimeover(520)
    assert p.bit_length() == 520 and ntheory.is_prime(p)


def test_without_a_toolchain_have_native_is_false(tmp_path):
    """A copy of the package with no library built, imported in a process
    whose PATH holds no g++: the library is absent, HAVE_NATIVE is False,
    and the scalar API and ntheory agree with CPython."""
    shutil.copytree(os.path.join(_REPO, "phe_tpu_torch"),
                    tmp_path / "phe_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import sys\n"
        "import phe_tpu_torch as pt\n"
        "from phe_tpu_torch import native, util\n"
        "from phe_tpu_torch.utils import ntheory\n"
        "assert native.__file__.startswith(%r), native.__file__\n"
        "assert not native.HAVE_NATIVE and native._lib is None\n"
        "assert not ntheory.HAVE_NATIVE and not util.HAVE_NATIVE\n"
        "c = 2**2048 - 159\n"
        "assert ntheory.powmod(2**2000 + 1, 2**1024 + 7, c) == "
        "pow(2**2000 + 1, 2**1024 + 7, c)\n"
        "try:\n"
        "    native.powmod(2, 3, c)\n"
        "    sys.exit('native.powmod ran without a library')\n"
        "except RuntimeError:\n"
        "    pass\n"
        "pub, priv = pt.generate_paillier_keypair(n_length=512)\n"
        "assert priv.decrypt(pub.encrypt(-7.25)) == -7.25\n"
        "print('OFF_OK')\n" % str(tmp_path)
    )
    env = dict(os.environ, PATH=str(tmp_path / "no-compiler"))
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path, env=env)
    assert out.returncode == 0 and "OFF_OK" in out.stdout, (
        out.stdout + out.stderr)
    assert not list((tmp_path / "build" / "native").glob("*.so"))
