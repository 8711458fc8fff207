"""The program's own spans in a traced stretch: the host encode and decode
layer's busy time, and the device's idle time spent waiting on it.

The program marks its host work with spans (``phe_tpu_torch.profiling``:
``SPANS``, of which ``HOST_SPANS`` are the host encode and decode layer)
on the profiler's timeline. Given the events of ``profiler_events(prof,
names)`` and ``names``, the harness's span names with the program's:

* ``host_busy_s``: the self time of the host spans, each one's duration
  less the union of the spans of ``names`` that lie inside it (a decode's
  read-back, which waits on the device);
* ``host_wait_s``: the device's idle seconds whose gap ``reduce`` puts
  down to a host span, by its own gaps and midpoint rule.
"""

from paillier_bench.devicetrace import _union, reduce


def host_busy_s(events, names, host_spans):
    spans = [(s, e, name) for name, dev, s, e in events
             if not dev and name in names]
    total = 0.0
    for span in spans:
        s, e, name = span
        if name not in host_spans:
            continue
        inner = [(a, b) for a, b, n in spans
                 if s <= a and b <= e and (a, b, n) != span]
        total += (e - s) - sum(b - a for a, b in _union(inner))
    return total * 1e-6


def host_wait_s(events, names, host_spans):
    _, _, gaps = reduce(events, names, top=len(names) + 1)
    return sum(seconds for label, seconds in gaps if label in host_spans)
