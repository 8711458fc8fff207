"""The issue-rate chain against phe_tpu's calibration kernel.

scripts/vpu_microbench.py is imported by path, and its kernel, ``_mk``,
rebuilt in Pallas interpret mode: the same ``kern`` body under
pl.pallas_call(..., interpret=True), so it runs on the CPU. For each of the
five bodies and K in {1, 5, 64}, on the full [256, 512] uint32 tile, its
output is bit-equal to the port's plain version and to the port's wrapper
on a CPU tensor (tolerance zero: exact integer arithmetic mod 2^32). The
bench itself needs a card and raises on the CPU: no CPU run prints a rate.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from phe_tpu_torch import microbench
from phe_tpu_torch.ops import cuda_microbench as cm

_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "scripts", "vpu_microbench.py")


def _load_script():
    spec = importlib.util.spec_from_file_location("vpu_microbench", _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


vm = _load_script()
# The five bodies of scripts/vpu_microbench.py:71-75.
BODIES = {
    "mul": lambda a, b: a * b,
    "add": lambda a, b: a + b,
    "muladd": lambda a, b: a * b + b,
    "shiftmul": lambda a, b: ((a >> 14) * b) >> 14,
    "barrett": vm.barrett,
}


def _mk_interpret(body, K):
    """scripts/vpu_microbench.py's _mk (:30-37) in interpret mode."""
    def kern(x_ref, o_ref):
        x = x_ref[:, :]
        o_ref[:, :] = jax.lax.fori_loop(0, K, lambda i, a: body(a, x), x)

    return jax.jit(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((vm.R, vm.TB), jnp.uint32),
        interpret=True))


def test_the_port_keeps_phe_tpus_bodies_and_tile():
    assert sorted(cm.BODIES) == sorted(BODIES)
    assert (microbench.R, microbench.TB) == (vm.R, vm.TB)
    assert [ops for _, _, ops in microbench.ROWS] == [1, 1, 2, 3, 7]


@pytest.mark.parametrize("body", sorted(BODIES))
def test_chain_bit_equal_to_the_pallas_kernel(body):
    rng = np.random.default_rng(len(body))
    x = rng.integers(0, 1 << 32, (vm.R, vm.TB), dtype=np.uint64).astype(
        np.uint32)
    xt = torch.as_tensor(x.view(np.int32))
    for K in (1, 5, 64):
        want = np.asarray(_mk_interpret(BODIES[body], K)(jnp.asarray(x)))
        plain = cm.issue_chain_plain(xt, body, K).numpy().view(np.uint32)
        np.testing.assert_array_equal(plain, want)
        before = dict(cm.launches)
        got = cm.issue_chain(xt, body, K)
        assert cm.launches == before  # the plain version launches nothing
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_wrapper_dispatch_and_checks():
    x = torch.ones((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown body"):
        cm.issue_chain(x, "dp4a", 3)
    with pytest.raises(ValueError, match="no issue chain"):
        cm.issue_chain(x.to("meta"), "mul", 3)
    assert torch.equal(cm.issue_chain(x, "add", 0), x)


def test_bench_raises_without_a_card():
    x = torch.ones((vm.R, vm.TB), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        microbench.bench("mul", "mul", 1, x)


def test_main_raises_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        microbench.main()
    assert "calibration" not in capsys.readouterr().out
