"""Run one cell of the port's benchmark once; print its result line.

    python3 paillier_bench/run.py --workload fl_2nn-2048 --seed 7 \
        --seconds 30 --trace 0

(or ``python -m paillier_bench.run`` from the checkout's root). Everything
a cell is comes from ``BENCHMARK.json`` at the root of the checkout, by
name: its configuration's file, its traffic mix's data file
``paillier_bench/traffic/<traffic>.json``, the protocol that file names
(``paillier_bench/protocols/<protocol>.py``), and a reader for each of
its metrics, ``paillier_bench/metrics/<name>.py`` or, for a name with a
dot, the reader of the part before the first dot.

A run: look for the card (no card, or fewer than the cell asks for, is
an error: nothing falls back to the CPU), print the card's name and
power limit, build the keys' device contexts and warm every shape the
mix uses (set-up, from the start of the process: ``setup_s``), then run
the mix as one closed loop for ``--seconds``, in one process. The window
closes at the end of the first step that ends at or past that time, so
that every step in it is whole. The device programs' graphs are counted
before and after it: a key first called or a graph captured inside the
window (a shape the warm-up did not reach) is counted, printed, and read
by the ``window_captures`` metrics. With ``--trace 1`` a short steady
stretch of steps runs under torch.profiler and the line carries the
per-layer metrics, else the end-to-end ones.
After the window: the memory peak is read, the sampled outputs are read
back through the program's export, the plain reference judges the
outputs on the host, and each number compared is printed beside its
limit, on standard error and as the line's last key. A run that finds
jax, jaxlib, flax or phe_tpu among its modules fails.

Nothing is written but the program's kernel and native builds, into
``build/`` inside the checkout.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "phe_tpu"))
# The traced stretch: from this step, for at least these seconds and
# steps, at most this many steps.
TRACE_FROM, TRACE_SECONDS, TRACE_MIN, TRACE_MAX = 1, 2.0, 3, 64
CONTROLS = ("float32", "no_obfuscation")


class Spec:
    """BENCHMARK.json of a checkout and the files it names."""

    def __init__(self, root):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def path(self, *parts):
        return os.path.join(self.root, "paillier_bench", *parts)

    def workload(self, name):
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit("no workload %r in BENCHMARK.json" % name)

    def config(self, name):
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise SystemExit("no config %r in BENCHMARK.json" % name)

    def traffic(self, name):
        with open(self.path("traffic", name + ".json")) as f:
            return json.load(f)

    def metrics(self, cell, trace):
        """The metrics this cell reports in a run of this kind."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.data[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, name):
        for stem in (name, name.split(".")[0]):
            path = self.path("metrics", stem + ".py")
            if os.path.exists(path):
                spec = importlib.util.spec_from_file_location(
                    "paillier_bench_metric_" + stem.replace(".", "_"), path)
                module = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(module)
                return module.read
        raise SystemExit("no reader for metric %r" % name)


class Run:
    """What a run measured, as the metric readers see it.

    unit: what a step completes; setup_s; steps: (index, start, end,
    units) of the window's steps, host clock; window_s; new_keys and
    new_graphs: device-program keys first called and graphs captured
    inside the window; trace: a Trace, or None when the run took none.
    """

    def __init__(self, unit, setup_s):
        self.unit, self.setup_s = unit, setup_s
        self.steps, self.window_s, self.trace = [], 0.0, None
        self.new_keys = self.new_graphs = 0


class Trace:
    """The traced stretch: steps, window_s (host clock), busy_s,
    least_s (the steps' least work in seconds) and launches (kernel
    launches, by form)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _launch_counts():
    from phe_tpu_torch.ops import cuda_modexp, cuda_rns

    return {**cuda_modexp.launches, **cuda_rns.launches}


def _graph_state():
    """({(program, key): captured} over the program's device programs,
    evictions so far)."""
    from phe_tpu_torch import programs

    return ({(id(p), k): e.graph is not None
             for p in list(programs._PROGRAMS) for k, e in p.graphs.items()},
            programs.evictions)


def _window_line(run, cpu_s):
    """The window's spread on standard error: step latencies, the rate
    of each fifth of the window and the process's CPU seconds."""
    if not run.steps:
        return
    lat = sorted(1e3 * (e - s) for _, s, e, _ in run.steps)
    start = run.steps[0][1]
    fifths = [0.0] * 5
    for _, _, e, units in run.steps:
        fifths[min(int(5 * (e - start) / run.window_s), 4)] += units
    print("window: %d steps, %.3f s, CPU %.3f s; step ms min %.1f "
          "median %.1f max %.1f; units a second by fifth %s"
          % (len(lat), run.window_s, cpu_s, lat[0],
             lat[len(lat) // 2], lat[-1],
             " ".join("%.0f" % (5 * u / run.window_s) for u in fifths)),
          file=sys.stderr)


def _phase(name, t0):
    print("set-up: %s done at %.3f s" % (name, time.perf_counter() - t0),
          file=sys.stderr)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(mix, seconds, trace, tracer, device):
    """The closed loop; returns (steps, window_s, failed, traced)."""
    import torch

    steps, failed, traced, prof = [], 0, None, None
    start = time.perf_counter()
    i = 0
    while True:
        if trace and prof is None and traced is None and i == TRACE_FROM:
            _sync(device)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
            tracer.active = True
            first, launches0 = i, _launch_counts()
            t_trace = time.perf_counter()
        data = mix.prepare(i)
        t0 = time.perf_counter()
        try:
            units = mix.step(i, data)
        except Exception:  # a failed step ends the window; the run fails
            traceback.print_exc()
            failed += 1
            break
        t1 = time.perf_counter()
        steps.append((i, t0, t1, units))
        i += 1
        if prof is not None and (
                (t1 - t_trace >= TRACE_SECONDS and i - first >= TRACE_MIN)
                or i - first >= TRACE_MAX):
            _sync(device)
            traced = dict(first=first, last=i,
                          window_s=time.perf_counter() - t_trace)
            launches1 = _launch_counts()
            tracer.active = False
            prof.__exit__(None, None, None)
            traced["prof"] = prof
            traced["launches"] = {k: launches1[k] - launches0[k]
                                  for k in launches1
                                  if launches1[k] != launches0[k]}
            prof = None
        if t1 - start >= seconds and (not trace or traced is not None):
            break
    if prof is not None:  # the window failed inside the traced stretch
        tracer.active = False
        prof.__exit__(None, None, None)
    return steps, (steps[-1][2] - start) if steps else 0.0, failed, traced


def device_info(device):
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": dev.type, "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def run_cell(root, name, seed, seconds, trace, device, control=None):
    """One run of one cell on device; returns the result line's dict."""
    spec = Spec(root)
    cell = spec.workload(name)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    build = os.path.join(ROOT, "build")
    os.environ["PHE_TPU_TORCH_CACHE_DIR"] = os.path.join(build, "kernels")
    os.environ["PHE_TPU_TORCH_NATIVE_DIR"] = os.path.join(build, "native")
    os.environ["PHE_TPU_TORCH_ENGINE"] = config["engine"]
    os.environ["PHE_TPU_TORCH_MXU"] = "1" if config["mxu"] else "0"
    import phe_tpu_torch

    here = os.path.dirname(os.path.abspath(phe_tpu_torch.__file__))
    if here != os.path.join(ROOT, "phe_tpu_torch"):
        raise SystemExit("phe_tpu_torch comes from %s, not from this "
                         "checkout" % here)
    import torch

    from paillier_bench.devicetrace import Tracer, profiler_events, reduce

    _phase("imports", _T0)
    if torch.device(device).type == "cuda":
        from phe_tpu_torch.ops import _build

        _build.build_all()
        _phase("kernel builds", _T0)
    protocol = importlib.import_module(
        "paillier_bench.protocols." + traffic["protocol"])
    tracer = Tracer()
    mix = protocol.Mix(config, traffic, seed, device, tracer, control)
    mix.setup()
    _sync(device)
    _phase("keys' device contexts", _T0)
    mix.warm()
    _sync(device)
    _phase("warm-up", _T0)
    run = Run(mix.unit, time.perf_counter() - _T0)
    graphs0, evictions0 = _graph_state()
    cpu0 = time.process_time()
    run.steps, run.window_s, failed, traced = window(
        mix, seconds, trace, tracer, device)
    _window_line(run, time.process_time() - cpu0)
    graphs1, evictions1 = _graph_state()
    run.new_keys = len(graphs1.keys() - graphs0.keys())
    run.new_graphs = sum(g and not graphs0.get(k, False)
                         for k, g in graphs1.items())
    print("window: %d keys first called, %d graphs captured, %d evictions"
          % (run.new_keys, run.new_graphs, evictions1 - evictions0),
          file=sys.stderr)
    result = {"correct": False, "attempted": len(run.steps) + failed,
              "failed": failed, "metrics": {}}
    dev_info = device_info(device)
    if traced is not None:
        busy_s, ops, gaps = reduce(
            profiler_events(traced["prof"], tracer.names), tracer.names)
        least = [mix.least(i) for i in range(traced["first"],
                                             traced["last"])]
        from paillier_bench import leastwork

        run.trace = Trace(
            steps=traced["last"] - traced["first"],
            window_s=traced["window_s"], busy_s=busy_s,
            least_s=sum(leastwork.least_seconds(o, b) for o, b in least),
            launches=traced["launches"])
        dev_info.update(busy_s=busy_s, window_s=traced["window_s"])
        result["breakdown"] = {"device_ops": ops, "idle_gaps": gaps}
    for m in spec.metrics(name, trace):
        value = spec.reader(m["name"])(run)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value,
                                            "unit": m["unit"]}
    result["device"] = dev_info
    # The reference runs on the host, after the peak is read and with
    # the sampled outputs read back: the device holds nothing it needs.
    mix.export()
    finished = [s[0] for s in run.steps]
    checks = mix.check(finished)
    result["correct"] = bool(finished) and not failed and all(
        value <= limit for value, limit in checks.values())
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def forbidden_modules():
    """Top-level names of loaded modules that no run may load."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def card_or_exit(chips):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is "
                         "False; this benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit("the cell asks for %d cards, %d present"
                         % (chips, torch.cuda.device_count()))
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = "nvidia-smi: %s" % e
    print("card: %s (%s)" % (torch.cuda.get_device_name(0),
                             out.replace("\n", "; ")), file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=CONTROLS, default=None,
                    help="run a control of the check in the program's "
                         "place (expected: correct false)")
    args = ap.parse_args(argv)
    cell = Spec(ROOT).workload(args.workload)
    card_or_exit(int(cell["chips"]))
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", args.control)
    found = forbidden_modules()
    if found:
        raise SystemExit("the run loaded %s" % ", ".join(found))
    for k, c in result["checks"].items():
        print("check %s: %s (limit %s)" % (k, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))


if __name__ == "__main__":
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path[0] = ROOT
    elif ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    main()
