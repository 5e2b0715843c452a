"""The benchmark's harness: it finds a cell's files by name, runs the cell's
loop through set-up, the measured window (or the traced slice) and the
output check, and reads the cell's metrics.

Nothing here names a configuration, a mix, a loop kind, a generator or a
metric: ``BENCHMARK.json`` lists the cells and metrics, and each piece lives
in a file of its own, found by its name: ``configs/<config>.json``,
``mixes/<traffic>.json`` (which names its loop kind), ``loops/<kind>.py``
(the loop, its kernels, its output check and its faults: see
``bench_port/loop.py``), ``scenes/``, ``cameras/`` and ``appearances/``
``<generator>.py`` (see ``bench_port/scene.py``), ``checks/<cell>.json``
(the limit of each number compared), ``metrics/<metric>.py`` (a reader:
``read(run)`` returns a number, or None where it finds nothing to read) and
``counts/<kernel>.py`` (``PATTERN``, a regular expression for the kernel's
device name, and ``count(run)``, its float operations and bytes).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import re
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent
# Top-level module names that no run may load: JAX and the JAX package.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "dmesh2_renderer_tpu")
_HUGE = 3.0e38


def load_spec(root: Path | None = None) -> dict:
    with open((root or BENCH.parent) / "BENCHMARK.json") as f:
        return json.load(f)


def load_data(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_port.{kind}.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_names() -> list[str]:
    """Every kernel that ``counts/`` has a file for."""
    return sorted(p.stem for p in (BENCH / "counts").glob("*.py") if not p.stem.startswith("_"))


def workload(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(spec: dict, cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` that ``cell`` reports: those that list it
    under ``workloads``; one without that key in every cell, a per-layer
    one in every cell that reports the end-to-end metric it moves."""
    ends = {m["name"] for m in cell_metrics(spec, cell, "end_to_end")} \
        if section == "per_layer" else set()
    out = []
    for m in spec[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in ends:
            out.append(m)
    return out


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def peaks(device_name: str) -> dict | None:
    with open(BENCH / "peaks.json") as f:
        return json.load(f).get(device_name)


class Spans:
    """Host-clock spans around calls into the program, with a profiler
    range of the same name; off (free) outside the traced slice."""

    def __init__(self, device):
        self.device = device
        self.enabled = False
        self.seconds = defaultdict(list)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = False):
        if not self.enabled:
            yield
            return
        from torch.profiler import record_function

        with record_function(name):
            if sync:
                self._sync()
            t0 = time.perf_counter()
            yield
            if sync:
                self._sync()
            self.seconds[name].append(time.perf_counter() - t0)


def merged_span(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            total += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


class Trace:
    """Device and host activity of a traced window, times in microseconds
    on the profiler's clock: ``device`` and ``host`` lists of (name, start,
    end), ``window`` (start, end)."""

    def __init__(self, device, host, window, iterations: int):
        self.window = window
        self.iterations = iterations
        w0, w1 = window
        self.device = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
        self.host = host

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return merged_span([(s, e) for _, s, e in self.device]) * 1e-6

    def durations(self, pattern: str) -> list[float]:
        """Seconds of each device operation whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return [(e - s) * 1e-6 for n, s, e in self.device if rx.search(n)]

    def other_seconds(self, patterns) -> float:
        """Device seconds in operations that match none of ``patterns``."""
        rxs = [re.compile(p) for p in patterns]
        return sum((e - s) * 1e-6 for n, s, e in self.device
                   if not any(rx.search(n) for rx in rxs))

    def top_ops(self, k: int = 10):
        by = defaultdict(float)
        for n, s, e in self.device:
            by[n[:120]] += (e - s) * 1e-6
        return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10):
        """The idle device time of the window by the innermost host
        operation running at each gap's middle, largest first."""
        w0, w1 = self.window
        ivals = sorted((s, e) for _, s, e in self.device)
        gaps, cur = [], w0
        for s, e in ivals:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if w1 > cur:
            gaps.append((cur, w1))
        if not gaps:
            return []
        names = [n for n, _, _ in self.host]
        starts = np.array([s for _, s, _ in self.host] or [0.0])
        ends = np.array([e for _, _, e in self.host] or [0.0])
        by = defaultdict(float)
        for s, e in gaps:
            mid = 0.5 * (s + e)
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = names[inside[np.argmax(starts[inside])]] if inside.size else "host idle"
            by[name[:120]] += (e - s) * 1e-6
        return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:k]


class Run:
    """What one run measured, for the metric readers."""

    def __init__(self, cell, config, mix, seed, device):
        self.cell, self.config, self.mix, self.seed = cell, config, mix, seed
        self.device = device
        self.device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        self.setup_s = None
        self.build_s = None
        self.window_s = None
        self.iterations = 0
        self.latencies_ms = []
        self.spans = {}
        self.trace = None
        self.scene = None
        self.reference = None
        self._cache = {}

    def cached(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    def kernel_count(self, kernel: str):
        """``counts/<kernel>.py``'s ops and bytes at this run's inputs."""
        return self.cached(("count", kernel), lambda: load_module("counts", kernel).count(self))

    def kernel_pattern(self, kernel: str) -> str:
        return self.cached(("pattern", kernel), lambda: load_module("counts", kernel).PATTERN)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_kernels(names, device) -> float:
    """Build (nvcc, a checkout's first run) or load the port's kernels
    ``names``, all builds at once; the seconds it took."""
    t0 = time.perf_counter()
    if device.type == "cuda" and names:
        from dmesh2_renderer_tpu_torch.ops import _kernels

        kernels = [k for k in _kernels.KERNELS if k.name in names]
        missing = set(names) - {k.name for k in kernels}
        if missing:
            raise KeyError(f"the port has no kernels {sorted(missing)}")
        with ThreadPoolExecutor(len(kernels)) as pool:
            list(pool.map(_kernels.Kernel.build, kernels))
        for k in kernels:
            k.load()
    return time.perf_counter() - t0


def measure_window(loop, seconds: float, run: Run):
    """Iterations of the closed loop until ``seconds`` have passed on the
    host clock, then a synchronise: the window is all of that."""
    dev = run.device
    _sync(dev)
    t0 = time.perf_counter()
    while True:
        lat = loop.step()
        run.iterations += 1
        if lat is not None:
            run.latencies_ms.append(lat)
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(dev)
    run.window_s = time.perf_counter() - t0


def trace_window(loop, iterations: int, run: Run, spans: Spans):
    """``iterations`` of the loop under ``torch.profiler``, with the
    harness's spans on."""
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = run.device
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _sync(dev)
    spans.enabled = True
    with profile(activities=acts) as prof:
        with record_function("bench_window"):
            t0 = time.perf_counter()
            for _ in range(iterations):
                lat = loop.step()
                run.iterations += 1
                if lat is not None:
                    run.latencies_ms.append(lat)
            _sync(dev)
            run.window_s = time.perf_counter() - t0
    spans.enabled = False
    run.spans = dict(spans.seconds)
    device, host, window = [], [], None
    # The harness's own ranges also appear on the device's timeline: they
    # are no device work.
    ranges = {"bench_window", *run.spans}
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and e.name not in ranges:
                device.append((e.name, tr.start, tr.end))
        else:
            host.append((e.name, tr.start, tr.end))
            if e.name == "bench_window":
                window = (tr.start, tr.end)
    if window is None:
        raise RuntimeError("the profiler recorded no bench_window range")
    run.trace = Trace(device, host, window, iterations)


def _number(x) -> float:
    x = float(x)
    return x if math.isfinite(x) else _HUGE


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print) -> dict:
    """Run one cell and return its result line (a dict).

    ``setup_s`` runs from ``t_start`` to the first measured iteration and
    holds the kernels' build or load, which ``build_s`` also gives apart."""
    from bench_port.scene import build_scene

    device = torch.device(device)
    cell = workload(spec, name)
    config = load_data("configs", cell["config"])
    mix = load_data("mixes", cell["traffic"])
    limits = load_data("checks", name)
    kind = load_module("loops", mix["loop"])
    loop_cls = kind.Loop
    run = Run(cell, config, mix, seed, device)
    run.build_s = build_kernels(kind.KERNELS, device)
    log(f"kernels built or loaded in {run.build_s:.3f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    scene = build_scene(config, seed, device)
    spans = Spans(device)
    loop = loop_cls(scene, config, mix, device, spans)
    for _ in range(int(mix["warmup"])):
        loop.step()
    _sync(device)
    loop.auxes = []
    run.setup_s = time.perf_counter() - t_start
    log(f"set-up {run.setup_s:.3f} s")

    if trace:
        trace_window(loop, int(mix["trace_iterations"]), run, spans)
    else:
        measure_window(loop, seconds, run)
    log(f"window {run.window_s:.3f} s, {run.iterations} iterations")
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = loop.failed()
    prog = loop.outputs(seed)
    loop.release()
    del loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    run.scene = scene
    run.reference = loop_cls.reference(scene, config, mix, "float32", prog)
    numbers = loop_cls.compare(prog, run.reference)
    log(f"reference and comparison {time.perf_counter() - t_ref:.3f} s")
    checks = {k: dict(value=_number(numbers[k]), limit=limits[k]) for k in numbers}
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"checks/{name}.json limits numbers this loop does not give: {missing}")
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(spec, name, section):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    dev_info = dict(platform="gpu" if device.type == "cuda" else device.type,
                    kind=run.device_name, count=1, memory_peak_bytes=int(memory_peak))
    result = dict(correct=bool(correct), attempted=run.iterations, failed=failed,
                  metrics=metrics, device=dev_info, build_s=run.build_s)
    if trace and run.trace is not None:
        dev_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = dict(device_ops=run.trace.top_ops(), idle_gaps=run.trace.idle_gaps())
    result["checks"] = checks
    return result
