"""The harness's spans, and the reduction of a profiler trace.

``Tracer.span(name)`` marks a call into one of the program's layers as a
``torch.profiler.record_function`` range while a trace is being taken,
and costs nothing otherwise; the tracer keeps the names it marked.
``reduce(profiler_events(prof, names), names)`` reads a finished
``torch.profiler.profile`` in memory (no trace file is written):

* busy: the seconds covered by the union of the device's operation
  intervals (kernels, copies, sets), as chip_smoke.py's ``_busy_us``
  takes them;
* device_ops: device seconds by operation name (its first NAME_CHARS
  characters), most first;
* idle_gaps: the seconds the device sat idle between the first and the
  last span of the trace, by the harness span that was open on the host
  at the middle of each gap ("host, outside the spans" where none was),
  most first.
"""

import contextlib

# Operation names are cut to this many characters (templates run long).
NAME_CHARS = 120


class Tracer:
    def __init__(self):
        self.active = False
        self.names = set()

    def span(self, name):
        if not self.active:
            return contextlib.nullcontext()
        import torch

        self.names.add(name)

        return torch.profiler.record_function(name)


def _union(spans):
    """Merged [start, end] intervals of a list of (start, end)."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _gaps(busy, lo, hi):
    """The (start, end) stretches of [lo, hi] outside the busy intervals."""
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def reduce(events, span_names, top=10):
    """(busy_s, device_ops, idle_gaps) of a profiler's events.

    events: (name, is_device, start_us, end_us) tuples; span_names: the
    names of the harness's spans among them.
    """
    device = [(s, e) for _, dev, s, e in events if dev]
    by_op = {}
    for name, dev, s, e in events:
        if dev:
            name = name[:NAME_CHARS]
            by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-6
    busy = _union(device)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    spans = [(name, s, e) for name, dev, s, e in events
             if not dev and name in span_names]
    by_gap = {}
    if spans:
        lo = min(s for _, s, _ in spans)
        hi = max(e for _, _, e in spans)
        for a, b in _gaps(busy, lo, hi):
            mid = (a + b) / 2
            open_ = [(s, name) for name, s, e in spans if s <= mid < e]
            label = max(open_)[1] if open_ else "host, outside the spans"
            by_gap[label] = by_gap.get(label, 0.0) + (b - a) * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
    return busy_s, [list(kv) for kv in ops], [list(kv) for kv in gaps]


def profiler_events(prof, span_names):
    """A finished torch.profiler.profile's events as reduce() takes them:
    the device's operations, and the host's events. The ranges that the
    spans also mark on the device's timeline are no operations and are
    left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.events():
        on_device = e.device_type == cuda
        if on_device and (getattr(e, "is_user_annotation", False)
                          or e.name in span_names):
            continue
        out.append((e.name, on_device, e.time_range.start, e.time_range.end))
    return out
