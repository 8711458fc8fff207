"""The port's batch programs against their eager bodies and phe_tpu's
jitted programs, and device_program's bookkeeping, on the CPU.

phe_tpu/batch.py wraps 24 programs in jax.jit; phe_tpu_torch/batch.py
defines each name as a device program (phe_tpu_torch.programs). On the
CPU a program is its eager body, so each is held equal to the body and to
phe_tpu's program on the same seeded inputs at a 256-bit key: Montgomery
rows value-equal mod n^2 (the limb engine's redundant limbs may differ,
as ROADMAP.md states), bytes, canonical limbs and compact rows
array-equal. Tolerance zero: all exact integer arithmetic. phe_tpu runs
its RNS engine with the XLA ladder (PHE_TPU_ENGINE=rns,
PHE_TPU_RNS_KERNEL=xla, as tests/test_engine_rns.py sets them).

Capture and replay need the card; their bookkeeping does not. A stub
graph backend stands in for CudaGraphs and shows the key, a warm-up at
a key's first call and one capture for three calls, the launch counts
added per replay, the outputs cloned, a graph dropped when its
constants die, and programs.calls counting each warm-up, capture and
replay, an eviction's re-warm included.
"""

import ast
import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phe_tpu
from phe_tpu import batch as jbatch

import phe_tpu_torch as pt
from phe_tpu_torch import batch as tbatch
from phe_tpu_torch import programs
from phe_tpu_torch.encoding import EncodedNumber
from phe_tpu_torch.ops import cuda_modexp, cuda_rns

CPU = torch.device("cpu")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEV_NAMES = (
    "_mul_mont_dev", "_pack_mont_dev", "_export_dev", "_encrypt_dev",
    "_obfuscate_dev", "_encrypt_rns_dev", "_obfuscate_rns_dev",
    "_add_encoded_dev", "_tree_reduce_dev", "_tree_reduce_masked_dev",
    "_matvec_dev", "_crt_powers_dev", "_add_encrypted_aligned_dev",
    "_add_scalars_aligned_dev", "_sum_aligned_dev", "_inverse_scan_dev",
    "_finish_inverse_dev", "_pow_select_dev", "_decrypt_dev",
    "_decrypt_compact_dev", "_decrypt_rns_dev", "_decrypt_compact_rns_dev",
    "_nude_encrypt_dev", "_pow_elems_dev",
)


def _jitted_names(tree):
    """Top-level functions under @jax.jit or functools.partial(jax.jit)."""
    out = set()
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            for dec in node.decorator_list:
                if "jax.jit" in ast.unparse(dec):
                    out.add(node.name)
    return out


def _program_names(tree):
    """Top-level names assigned device_program(...)."""
    out = set()
    for node in tree.body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and ast.unparse(node.value.func) == "device_program"):
            out.update(t.id for t in node.targets)
    return out


def test_batch_defines_every_jitted_name_of_phe_tpu():
    def parse(path):
        with open(os.path.join(_REPO, path)) as f:
            return ast.parse(f.read())

    assert _jitted_names(parse("phe_tpu/batch.py")) == set(DEV_NAMES)
    mine = _program_names(parse("phe_tpu_torch/batch.py"))
    assert set(DEV_NAMES) <= mine
    for name in mine:
        assert isinstance(getattr(tbatch, name), programs.DeviceProgram)


# -- each program against its body and phe_tpu's --------------------------

A = [1.5, -2.0, 300.0, 0.0625]
S = [2.5e-3, -7.0, 1e3, 0.5]


@pytest.fixture(autouse=True)
def _force_rns(monkeypatch):
    monkeypatch.setenv("PHE_TPU_ENGINE", "rns")
    monkeypatch.setenv("PHE_TPU_RNS_KERNEL", "xla")


class _Side(NamedTuple):
    """One package's contexts and inputs, built from the same numpy."""

    dc: object
    pdc: object
    mont: object  # [4, L] Montgomery rows of the ciphertexts
    inv: object  # [4, L] their inverses
    m_bytes: object
    r_bytes: object
    digits: object  # [4, W] per-row schedules
    grid: object  # [2, 4, W] matvec schedules
    neg: object  # [4] negative mask
    neg_grid: object  # [2, 4]
    valid: object  # [4] rows of the masked tree
    tinv: object  # [L] one Montgomery row


@pytest.fixture(scope="module")
def sides():
    jpub, jpriv = phe_tpu.generate_paillier_keypair(n_length=256)
    pub = pt.PaillierPublicKey(jpub.n)
    priv = pt.PaillierPrivateKey(pub, jpriv.p, jpriv.q)
    nsq = pub.nsquare
    g = np.random.default_rng(91)
    rs = [1 + int(v) % (pub.n - 1) for v in g.integers(1, 1 << 62, 4)]
    encs = EncodedNumber.encode_many(pub, A)
    cts = [pub.raw_encrypt(e.encoding, r_value=r) for e, r in zip(encs, rs)]
    inv = [pow(c, -1, nsq) for c in cts]
    res = [e.encoding for e in EncodedNumber.encode_many(pub, S)]
    exps = [int(v) for v in g.integers(1, 1 << 40, 4)]
    digits = tbatch._digits_rows(exps, 40)
    grid = tbatch._digits_rows([int(v) for v in g.integers(1, 1 << 20, 8)],
                               20).reshape(2, 4, -1)
    neg = np.array([0, 1, 1, 0], np.uint32)
    neg_grid = np.array([[1, 0, 0, 1], [0, 1, 0, 0]], np.uint32)
    valid = np.array([1, 1, 0, 1], np.uint32)
    tinv = int(g.integers(1, 1 << 62)) % nsq

    jdc, jpdc = jpub.device_context(), jpriv.device_context()
    dc, pdc = pub.device_context(CPU), priv.device_context(CPU)
    mine = _Side(
        dc, pdc, dc.pack_mod_nsquare(cts), dc.pack_mod_nsquare(inv),
        dc.pack_messages(res), dc.random_r_bytes(4, rs),
        tbatch._digits_on(digits, CPU), tbatch._digits_on(grid, CPU),
        torch.as_tensor(neg != 0), torch.as_tensor(neg_grid != 0),
        torch.as_tensor(valid != 0), dc.pack_mod_nsquare([tinv])[0])
    theirs = _Side(
        jdc, jpdc, jdc.pack_mod_nsquare(cts), jdc.pack_mod_nsquare(inv),
        jdc.pack_messages(res), jdc.random_r_bytes(4, rs),
        jnp.asarray(digits), jnp.asarray(grid), jnp.asarray(neg),
        jnp.asarray(neg_grid), jnp.asarray(valid),
        jdc.pack_mod_nsquare([tinv])[0])
    return mine, theirs


def _cases():
    """name -> (port arguments, phe_tpu arguments, compare), each from a
    side; compare "mont" holds Montgomery rows value-equal mod n^2 and
    "array" every output array-equal."""
    def halves(s):
        return tuple(s.pdc.rns_state())

    def excl(s, prog):
        return prog(s.mont, s.dc.ctx)[0]

    return {
        "_mul_mont_dev": (lambda s: (s.mont, s.inv, s.dc.ctx),
                          lambda s: (s.mont, s.inv, s.dc.ctx), "mont"),
        "_pack_mont_dev": (lambda s: (s.inv, s.dc.ctx),
                           lambda s: (s.inv, s.dc.ctx), "mont"),
        "_export_dev": (lambda s: (s.mont, s.dc.ctx),
                        lambda s: (s.mont, s.dc.ctx), "array"),
        "_encrypt_dev": (
            lambda s: (s.m_bytes, s.r_bytes, s.dc.nr2_limbs, s.dc.n_digits,
                       s.dc.ctx, s.dc.Ln),
            lambda s: (s.m_bytes, s.r_bytes, s.dc.n_limbs, s.dc.nr2_limbs,
                       s.dc.n_digits, s.dc.ctx, s.dc.Ln), "mont"),
        "_obfuscate_dev": (
            lambda s: (s.mont, s.r_bytes, s.dc.n_digits, s.dc.ctx),
            lambda s: (s.mont, s.r_bytes, s.dc.n_digits, s.dc.ctx), "mont"),
        "_encrypt_rns_dev": (
            lambda s: (s.m_bytes, s.r_bytes, s.dc.nr2_limbs, s.dc.n_digits,
                       s.dc.ctx, s.dc.rns_state(), s.dc.Ln),
            lambda s: (s.m_bytes, s.r_bytes, s.dc.n_limbs, s.dc.nr2_limbs,
                       s.dc.n_digits, s.dc.ctx, s.dc.rns_state(), s.dc.Ln),
            "mont"),
        "_obfuscate_rns_dev": (
            lambda s: (s.mont, s.r_bytes, s.dc.n_digits, s.dc.ctx,
                       s.dc.rns_state()),
            lambda s: (s.mont, s.r_bytes, s.dc.n_digits, s.dc.ctx,
                       s.dc.rns_state()), "mont"),
        "_add_encoded_dev": (
            lambda s: (s.mont, s.m_bytes, s.dc.nr2_limbs, s.dc.ctx, s.dc.Ln),
            lambda s: (s.mont, s.m_bytes, s.dc.n_limbs, s.dc.nr2_limbs,
                       s.dc.ctx, s.dc.Ln), "mont"),
        "_tree_reduce_dev": (lambda s: (s.mont, s.dc.ctx),
                             lambda s: (s.mont, s.dc.ctx), "mont"),
        "_tree_reduce_masked_dev": (lambda s: (s.mont, s.valid, s.dc.ctx),
                                    lambda s: (s.mont, s.valid, s.dc.ctx),
                                    "mont"),
        "_matvec_dev": (  # the shared table against phe_tpu's ladder grid
            lambda s: (s.mont, s.inv, s.neg_grid, s.grid, s.dc.ctx),
            lambda s: (s.mont, s.inv, s.neg_grid, s.grid, s.dc.ctx,
                       s.dc.rns_state()), "mont"),
        "_crt_powers_dev": (
            lambda s: (s.mont, s.dc.ctx, s.pdc.consts),
            lambda s: (s.mont, s.dc.ctx, s.pdc.ctx_p, s.pdc.red_p,
                       s.pdc.dp_digits, s.pdc.ctx_q, s.pdc.red_q,
                       s.pdc.dq_digits), "array"),
        "_add_encrypted_aligned_dev": (
            lambda s: (s.mont, s.digits, s.inv, s.digits, s.dc.ctx,
                       s.dc.rns_state()),
            lambda s: (s.mont, s.digits, s.inv, s.digits, s.dc.ctx,
                       s.dc.rns_state()), "mont"),
        "_add_scalars_aligned_dev": (
            lambda s: (s.mont, s.digits, s.m_bytes, s.dc.nr2_limbs, s.dc.ctx,
                       s.dc.rns_state(), s.dc.Ln),
            lambda s: (s.mont, s.digits, s.m_bytes, s.dc.n_limbs,
                       s.dc.nr2_limbs, s.dc.ctx, s.dc.rns_state(), s.dc.Ln),
            "mont"),
        "_sum_aligned_dev": (
            lambda s: (s.mont, s.digits, s.dc.ctx, s.dc.rns_state()),
            lambda s: (s.mont, s.digits, s.dc.ctx, s.dc.rns_state()),
            "mont"),
        "_inverse_scan_dev": (lambda s: (s.mont, s.dc.ctx),
                              lambda s: (s.mont, s.dc.ctx), "mont"),
        "_finish_inverse_dev": (
            lambda s: (excl(s, tbatch._inverse_scan_dev), s.tinv, s.dc.ctx),
            lambda s: (excl(s, jbatch._inverse_scan_dev), s.tinv, s.dc.ctx),
            "mont"),
        "_pow_select_dev": (
            lambda s: (s.mont, s.inv, s.neg, s.digits, s.dc.ctx,
                       s.dc.rns_state()),
            lambda s: (s.mont, s.inv, s.neg, s.digits, s.dc.ctx,
                       s.dc.rns_state()), "mont"),
        "_decrypt_dev": (lambda s: (s.mont, s.dc.ctx, s.pdc.consts),
                         lambda s: (s.mont, s.dc.ctx, s.pdc.consts), "array"),
        "_decrypt_compact_dev": (
            lambda s: (s.mont, s.dc.ctx, s.pdc.consts),
            lambda s: (s.mont, s.dc.ctx, s.pdc.consts), "array"),
        "_decrypt_rns_dev": (
            lambda s: (s.mont, s.dc.ctx, s.pdc.consts) + halves(s),
            lambda s: (s.mont, s.dc.ctx, s.pdc.consts) + halves(s), "array"),
        "_decrypt_compact_rns_dev": (
            lambda s: (s.mont, s.dc.ctx, s.pdc.consts) + halves(s),
            lambda s: (s.mont, s.dc.ctx, s.pdc.consts) + halves(s), "array"),
        "_nude_encrypt_dev": (
            lambda s: (s.m_bytes, s.dc.nr2_limbs, s.dc.ctx, s.dc.Ln),
            lambda s: (s.m_bytes, s.dc.n_limbs, s.dc.nr2_limbs, s.dc.ctx,
                       s.dc.Ln), "mont"),
        "_pow_elems_dev": (
            lambda s: (s.mont, s.digits, s.dc.ctx, s.dc.rns_state()),
            lambda s: (s.mont, s.digits, s.dc.ctx, s.dc.rns_state()),
            "mont"),
    }


def _flat(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("name", DEV_NAMES)
def test_program_equals_its_body_and_phe_tpu(sides, name):
    mine, theirs = sides
    port_args, jax_args, compare = _cases()[name]
    prog = getattr(tbatch, name)
    args = port_args(mine)
    got = _flat(prog(*args))
    for g, b in zip(got, _flat(prog.fn(*args))):
        assert torch.equal(g, b)
    want = _flat(getattr(jbatch, name)(*jax_args(theirs)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if compare == "mont":
            g = g.reshape(-1, g.shape[-1])
            assert mine.dc.export_ints(g) == theirs.dc.export_ints(
                jnp.asarray(w.reshape(-1, w.shape[-1])))
        else:
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int64)
                                          if g.dtype == torch.int64 else w)


# -- device_program's bookkeeping, through a stub graph backend -----------


class _Ctx(NamedTuple):
    scale: torch.Tensor


class _StubGraph:
    """Records fn as a capture would; a replay reruns it into the same
    output tensors, without its Python (the counts), as a graph does."""

    def __init__(self, fn):
        self.fn = fn
        self.outputs = fn()

    def replay(self):
        before = programs._counts()
        new = self.fn()
        programs._moved(before)
        for buf, t in zip(self.outputs, new):
            buf.copy_(t)


class _StubGraphs:
    def __init__(self):
        self.warmups = self.captures = self.replays = 0

    def warm_up(self, dev, fn):
        self.warmups += 1
        return fn()

    def capture(self, dev, fn):
        self.captures += 1
        graph = _StubGraph(fn)
        return graph, graph.outputs

    def replay(self, graph):
        self.replays += 1
        graph.replay()


def _body(x, ctx, k):
    cuda_modexp.launches["mont_mul"] += 1
    cuda_rns.launches["rns_ladder"] += 2
    return x * ctx.scale + k, x.sum(dim=-1)


def _moves(fn):
    """fn()'s result and how far it moved the two counts."""
    before = (cuda_modexp.launches["mont_mul"],
              cuda_rns.launches["rns_ladder"])
    out = fn()
    return out, (cuda_modexp.launches["mont_mul"] - before[0],
                 cuda_rns.launches["rns_ladder"] - before[1])


def test_device_program_captures_once_and_counts_each_replay(monkeypatch):
    monkeypatch.setitem(cuda_modexp.launches, "mont_mul", 0)
    monkeypatch.setitem(cuda_rns.launches, "rns_ladder", 0)
    prog = programs.device_program(_body, static_argnames=("k",))
    stub = _StubGraphs()
    ctx = _Ctx(torch.tensor([2, 3, 5]))
    xs = [torch.tensor([[1, 2, 3], [4, 5, 6]]) * (i + 1) for i in range(3)]
    outs = []
    for x in xs:
        out, moved = _moves(lambda: prog.run(CPU, {"x": x, "ctx": ctx,
                                                   "k": 7}, stub))
        # The first call's warm-up launched; the second's capture launched
        # nothing, its replay as much as the body.
        assert moved == (1, 2)
        outs.append(out)
    assert (stub.warmups, stub.captures, stub.replays) == (1, 1, 2)
    assert len(prog.graphs) == prog.captured == 1
    (entry,) = prog.graphs.values()
    assert entry.counts == [{"mont_mul": 1}, {"rns_ladder": 2}]
    assert cuda_rns.launches["rns_ladder"] == 2 * len(xs)
    assert [r() for r in entry.refs] == [ctx.scale]
    for x, out in zip(xs, outs):
        want = _body(x, ctx, 7)
        assert all(torch.equal(o, w) for o, w in zip(out, want))
    # Clones: no output is the graph's own, and a later replay leaves an
    # earlier result as it was.
    ptrs = {t.data_ptr() for t in entry.outputs}
    assert not ptrs & {t.data_ptr() for out in outs for t in out}
    assert torch.equal(outs[1][0], xs[1] * ctx.scale + 7)


def test_device_program_key():
    prog = programs.device_program(_body, static_argnames=("k",))
    stub = _StubGraphs()
    x = torch.ones((2, 3), dtype=torch.int64)
    ctx = _Ctx(torch.tensor([2, 3, 5]))
    calls = [
        (x, ctx, 7), (x + 1, ctx, 7),  # one key, data differ: captured
        (x, ctx, 8),  # a static value
        (torch.ones((4, 3), dtype=torch.int64), ctx, 7),  # a shape
        (x.to(torch.int32), ctx, 7),  # a dtype
        (x, _Ctx(ctx.scale.clone()), 7),  # another context object
    ]
    for x_, c, k in calls:
        prog.run(CPU, {"x": x_, "ctx": c, "k": k}, stub)
    # Six calls at five keys: five warm-ups, the key called twice captured.
    assert (stub.warmups, stub.captures, stub.replays) == (5, 1, 1)
    assert len(prog.graphs) == 5 and prog.captured == 1
    with pytest.raises(TypeError, match="host value"):
        prog.run(CPU, {"x": x, "ctx": np.ones(3), "k": 7}, stub)
    with pytest.raises(TypeError, match="constant argument holds"):
        prog.run(CPU, {"x": x, "ctx": (np.ones(3),), "k": 7}, stub)


class _BareGraphs(_StubGraphs):
    """Keeps no reference to what it captured, as a CUDA graph keeps none
    to the Python objects of its arguments; its replays do nothing."""

    def capture(self, dev, fn):
        self.captures += 1
        return object(), fn()

    def replay(self, graph):
        self.replays += 1


def test_device_program_drops_a_graph_whose_constants_died():
    prog = programs.device_program(_body, static_argnames=("k",))
    stub = _BareGraphs()
    x = torch.ones((2, 3), dtype=torch.int64)
    keep, gone = _Ctx(torch.tensor([2, 3, 5])), _Ctx(torch.tensor([7, 1, 1]))
    for c in (keep, gone):
        prog.run(CPU, {"x": x, "ctx": c, "k": 1}, stub)
    assert len(prog.graphs) == 2
    del gone, c
    prog.run(CPU, {"x": x, "ctx": keep, "k": 1}, stub)  # a replay
    assert len(prog.graphs) == prog.captured == stub.captures == 1
    with pytest.raises(ValueError, match="no argument"):
        programs.device_program(_body, static_argnames=("ln",))


def test_device_program_on_the_cpu_runs_its_body(monkeypatch):
    stub = _StubGraphs()
    monkeypatch.setattr(programs, "GRAPHS", stub)
    prog = programs.device_program(_body, static_argnames=("k",))
    x, ctx = torch.ones((2, 3), dtype=torch.int64), _Ctx(torch.tensor([1]))
    out = prog(x, ctx, k=3)
    assert torch.equal(out[0], x + 3)
    prog(x, ctx, k=3)
    assert (stub.warmups, stub.captures, len(prog.graphs)) == (0, 0, 0)
    with pytest.raises(ValueError, match="one device"):
        prog(np.ones(3), ctx, 3)


def test_out_of_memory_evicts_every_graph_and_runs_once_more():
    stub = _StubGraphs()
    progs = [programs.device_program(_body, static_argnames=("k",))
             for _ in range(2)]
    x, ctx = torch.ones((2, 3), dtype=torch.int64), _Ctx(torch.tensor([1]))
    for prog in progs:
        for _ in range(2):
            prog.run(CPU, {"x": x, "ctx": ctx, "k": 1}, stub)
        assert prog.captured == 1
    tries = []

    def thunk():
        tries.append(1)
        if len(tries) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return "ran"

    assert programs._with_room(CPU, thunk) == "ran"
    assert len(tries) == 2
    assert all(not prog.graphs for prog in progs)
    tries.clear()

    def never():
        tries.append(1)
        raise torch.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(torch.OutOfMemoryError):
        programs._with_room(CPU, never)
    assert len(tries) == 2


def test_calls_count_warm_ups_captures_and_replays(monkeypatch):
    """programs.calls counts what DeviceProgram.run did, as the stub saw
    it; after an eviction the key warms up and captures again."""
    for k in programs.calls:
        monkeypatch.setitem(programs.calls, k, 0)
    monkeypatch.setattr(programs, "evictions", programs.evictions)
    stub = _StubGraphs()
    prog = programs.device_program(_body, static_argnames=("k",))
    x, ctx = torch.ones((2, 3), dtype=torch.int64), _Ctx(torch.tensor([1]))

    def call():
        prog.run(CPU, {"x": x, "ctx": ctx, "k": 1}, stub)
        return dict(programs.calls)

    assert call() == {"warm_up": 1, "capture": 0, "replay": 0}
    assert call() == {"warm_up": 1, "capture": 1, "replay": 1}
    assert call() == {"warm_up": 1, "capture": 1, "replay": 2}
    programs.evict(CPU)
    assert call() == {"warm_up": 2, "capture": 1, "replay": 2}
    assert call() == {"warm_up": 2, "capture": 2, "replay": 3}
    assert call() == {"warm_up": 2, "capture": 2, "replay": 4}
    assert (stub.warmups, stub.captures, stub.replays) == (2, 2, 4)
