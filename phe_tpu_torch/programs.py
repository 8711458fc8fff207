"""Device programs: each batch program captured once as a CUDA graph.

The port's counterpart of ``jax.jit`` as phe_tpu/batch.py uses it. On
phe_tpu's chip each batch program (``_encrypt_rns_dev``,
``_decrypt_rns_dev``, ...) is one compiled executable per shape bucket,
dispatched in one call. ``device_program(fn)`` gives the port the same:
on the card, ``fn``'s kernel launches and tensor ops are captured once per
key as a ``torch.cuda.CUDAGraph`` and replayed at every later call, one
launch from the host in place of the body's few hundred.

The key of a graph, as jit's cache key:

* the function (each program keeps its own graphs);
* the value of each argument named in ``static_argnames`` (``ln``, as in
  phe_tpu's ``static_argnames=("ln",)``);
* the shape and dtype of each tensor argument (the row buckets are
  ``batch.bucket_rows``) and their device;
* every other argument, a constant context (``ctx``, ``st``,
  ``rstate``, ``pk``, the decrypt halves: tuples of tensors and integers):
  each tensor in it by identity, since the graph reads it where it lies,
  and each integer by value. The graph keeps a weak reference to each such
  tensor; when one dies, the graph is dropped at the program's next call,
  before its id could come back, and with it the graph's buffers (a key
  that is gone, such as a CLI command's, leaves nothing on the card).

Tensor arguments are the call's data: copied into the graph's static
inputs before each replay. Host arrays and Python scalars that are not
static are refused on the card: they would be copied or read inside the
program. The first call at a key warms it up: it runs ``fn`` eagerly on a
side stream (every lazy build, such as the kernels' packed operands and
the gathers' index tensors, happens there) and returns that result. The
second call captures ``fn`` on the same stream; it and every later call
copy their tensors in, replay, and return clones of the graph's outputs,
which the next replay overwrites. A key called once (a one-off batch,
such as a setup's 524,288-row encrypt) so never holds a graph: a capture
takes a second copy of the program's intermediates on the card (the
ladder's window table alone is 38.5 GiB at that size), kept in the
graphs' pool for as long as graphs live.
All graphs of a device share one memory pool: they replay one at a time
on the current stream, and nothing of a graph's outputs is handed out
uncloned. The pool keeps what its graphs held at their peaks, so a
warm-up or capture that runs out of memory evicts every graph of the
device, releases the pool and runs once more (evict()); a second
failure, or any other, raises. Nothing falls back to eager work.

The kernel wrappers count their launches in Python, which a replay does
not run. A capture records how far each count moved and puts the counts
back (nothing ran); each replay adds what its capture recorded. So a call
counts the same launches whether it ran eagerly or replayed. ``calls``
counts the cache's own work: warm-ups (a key's first call, or its first
after an eviction), captures and replays.

On the CPU ``fn`` runs as it is, and nothing captures. Each call, on
either device, is the span ``program.<fn>`` (profiling.span).
"""

import functools
import inspect
import numbers
import weakref

import numpy as np
import torch

from phe_tpu_torch import profiling
from phe_tpu_torch.ops import cuda_modexp, cuda_rns

# The kernel wrappers' launch counters.
COUNTERS = (cuda_modexp.launches, cuda_rns.launches)


def _counts():
    return [dict(c) for c in COUNTERS]


def _moved(before):
    """The counts' change since before, then the counts put back."""
    moved = [{k: c[k] - b[k] for k in c if c[k] != b[k]}
             for c, b in zip(COUNTERS, before)]
    for c, b in zip(COUNTERS, before):
        c.update(b)
    return moved


def _add(moved):
    for c, m in zip(COUNTERS, moved):
        for k, v in m.items():
            c[k] += v


def _map(out, fn):
    """fn over a tensor or a tuple of tensors (a program's outputs)."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    return tuple(_map(o, fn) for o in out)


class CudaGraphs:
    """Warm-up, capture and replay on the card: one side stream for the
    warm-ups and the captures of each device, and one memory pool that all
    its graphs share."""

    def __init__(self):
        self._streams = {}
        # dev -> (the pool's handle, the graphs captured into it, weakly).
        self._pools = {}

    def _side(self, dev):
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        side = self._streams[dev]
        side.wait_stream(torch.cuda.current_stream(dev))
        return side

    def warm_up(self, dev, fn):
        side = self._side(dev)
        with torch.cuda.stream(side):
            out = fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        return out

    def capture(self, dev, fn):
        """(graph, its static outputs). As torch.cuda.graph does, the
        blocks cached for eager work are freed on the card first, so that
        the graphs' pool can take them; unlike it, no synchronise and no
        garbage collection (the side stream has run the warm-up). A pool
        whose graphs have all been dropped (their keys died) is not
        captured into again: PyTorch's pinned-memory allocator keeps such
        a pool's id with no user, and a capture into it fails an internal
        assert; the next capture opens a new pool."""
        graph = torch.cuda.CUDAGraph()
        side = self._side(dev)
        pool = self._pools.get(dev)
        if pool is None or not pool[1]:
            pool = self._pools[dev] = (torch.cuda.graph_pool_handle(),
                                       weakref.WeakSet())
        torch.cuda.empty_cache()
        with torch.cuda.device(dev), torch.cuda.stream(side):
            graph.capture_begin(pool=pool[0])
            try:
                out = fn()
            finally:
                graph.capture_end()
        pool[1].add(graph)
        return graph, out

    def drop_pool(self, dev):
        """Forget dev's pool; the next capture opens a new one."""
        self._pools.pop(dev, None)

    def replay(self, graph):
        graph.replay()


GRAPHS = CudaGraphs()
# Every DeviceProgram, for evict(); and how many times it has run.
_PROGRAMS = weakref.WeakSet()
evictions = 0
# DeviceProgram.run's warm-ups, captures and replays, all programs.
calls = {"warm_up": 0, "capture": 0, "replay": 0}


def evict(dev):
    """Drop every program's graphs and warm-ups on dev, and the memory of
    their pool: the graphs are a cache, and this is its answer to memory
    pressure. Each key warms up and captures again at its next calls."""
    global evictions
    evictions += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # no graph is destroyed mid-replay
    for prog in list(_PROGRAMS):
        for key in [k for k in prog.graphs if k[0] == dev]:
            del prog.graphs[key]
    GRAPHS.drop_pool(dev)
    torch.cuda.empty_cache()


def _with_room(dev, thunk):
    """thunk(), run once more after evict(dev) if the card ran out of
    memory: the pool keeps what its graphs held at their peaks, which
    eager work and the next capture may need. A second failure raises."""
    try:
        return thunk()
    except torch.OutOfMemoryError:
        pass  # leave the handler first: its traceback holds tensors
    evict(dev)
    return thunk()


class _Captured:
    """A key's entry: its graph (None until captured), static inputs and
    outputs, the launch counts a replay adds, and weak references to its
    constant tensors."""

    __slots__ = ("graph", "inputs", "outputs", "counts", "refs")

    def __init__(self, graph, inputs, outputs, counts, refs):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.counts, self.refs = counts, refs


def _frozen(x, tensors):
    """A constant as a key: its tensors by identity (collected into
    tensors), its integers by value, its tuples' structure kept."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return ("tensor", id(x))
    if isinstance(x, tuple):
        return (type(x).__name__,) + tuple(_frozen(y, tensors) for y in x)
    if x is None or isinstance(x, (int, str)):
        return x
    raise TypeError("a constant argument holds a %s; constants are tuples "
                    "of tensors and integers" % type(x).__name__)


class DeviceProgram:
    """A batch program: fn captured per key on the card, eager on the CPU.

    ``fn`` keeps the eager body; ``graphs`` maps each key seen to its
    entry, whose graph is None until the key's second call.
    """

    def __init__(self, fn, static_argnames=()):
        self.fn = fn
        self.signature = inspect.signature(fn)
        self.static = frozenset(static_argnames)
        unknown = self.static - set(self.signature.parameters)
        if unknown:
            raise ValueError("%s has no argument %s"
                             % (fn.__name__, ", ".join(sorted(unknown))))
        self.graphs = {}
        self.span = "program." + fn.__name__
        profiling.SPANS.add(self.span)
        # Keys whose constants died (weakref callbacks), dropped at the
        # next call rather than inside a callback that may run mid-capture.
        self._dead = []
        functools.update_wrapper(self, fn)
        _PROGRAMS.add(self)

    def __call__(self, *args, **kwargs):
        with profiling.span(self.span):
            bound = self.signature.bind(*args, **kwargs)
            bound.apply_defaults()
            devices = {v.device for v in bound.arguments.values()
                       if isinstance(v, torch.Tensor)}
            if len(devices) != 1:
                raise ValueError("%s takes its tensors on one device, got %s"
                                 % (self.__name__, sorted(map(str, devices))))
            dev = devices.pop()
            if dev.type != "cuda":
                return self.fn(*args, **kwargs)
            return self.run(dev, bound.arguments, GRAPHS)

    def _key(self, dev, arguments):
        """(key, the constants' tensors). A context enters by the identity
        of its tensors, so a graph captured for a Montgomery context with
        REDC matrices never replays for one without: the REDC body is fixed
        when a context is built (montgomery.build_context) and recorded
        against its m tensor."""
        parts, tensors = [dev], []
        for name, v in arguments.items():
            if name in self.static:
                parts.append((name, v))
            elif isinstance(v, torch.Tensor):
                parts.append((name, tuple(v.shape), v.dtype))
            elif isinstance(v, (np.ndarray, numbers.Number, str, bytes)):
                raise TypeError(
                    "%s: argument %s is a host value; pass a tensor on %s "
                    "or name it in static_argnames" % (self.__name__, name,
                                                       dev))
            else:
                parts.append((name, _frozen(v, tensors)))
        return tuple(parts), tensors

    def run(self, dev, arguments, graphs):
        """Replay the graph of these arguments' key, capturing it first
        (graphs: the capture and replay backend, CudaGraphs on the card)."""
        while self._dead:
            self.graphs.pop(self._dead.pop(), None)
        key, tensors = self._key(dev, arguments)
        names = [n for n, v in arguments.items()
                 if isinstance(v, torch.Tensor) and n not in self.static]
        entry = self.graphs.get(key)
        if entry is None:
            out = _with_room(dev, lambda: graphs.warm_up(
                dev, lambda: self.fn(**arguments)))
            calls["warm_up"] += 1
            dead = self._dead
            refs = [weakref.ref(t, lambda _, k=key: dead.append(k))
                    for t in tensors]
            self.graphs[key] = _Captured(None, None, None, None, refs)
            return out
        if entry.graph is None:
            def capture():
                inputs = [torch.empty(arguments[n].shape,
                                      dtype=arguments[n].dtype, device=dev)
                          for n in names]
                static = dict(arguments, **dict(zip(names, inputs)))
                moved = []

                def body():  # nothing runs: count nothing, note what would
                    before = _counts()
                    try:
                        return self.fn(**static)
                    finally:
                        moved.append(_moved(before))

                graph, outputs = graphs.capture(dev, body)
                return graph, inputs, outputs, moved[-1]

            (entry.graph, entry.inputs, entry.outputs,
             entry.counts) = _with_room(dev, capture)
            calls["capture"] += 1
            self.graphs[key] = entry  # again, if the capture evicted it
        for buf, n in zip(entry.inputs, names):
            buf.copy_(arguments[n])
        graphs.replay(entry.graph)
        calls["replay"] += 1
        _add(entry.counts)
        outputs = entry.outputs
        try:
            return _map(outputs, torch.clone)
        except torch.OutOfMemoryError:
            pass
        # This graph goes too (its outputs stay until cloned), so that the
        # pool's other blocks can be freed on the card.
        entry.graph = entry.inputs = entry.outputs = None
        evict(dev)
        return _map(outputs, torch.clone)

    @property
    def captured(self):
        """The graphs this program holds."""
        return sum(e.graph is not None for e in self.graphs.values())


def device_program(fn, static_argnames=()):
    """fn as a batch program (DeviceProgram)."""
    return DeviceProgram(fn, static_argnames)
