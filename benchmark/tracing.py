"""The measured window, and with `--trace 1` the traced tail after it,
read from torch.profiler's Chrome trace.

A driver runs its traffic while `measuring()`, then calls `close()` (after
its own synchronise, where its metric needs one): the window's seconds end
there, and nothing of the tracer runs inside them, so a traced run's
host-clock metrics are read over a window like an untraced run's. With
tracing on, the same traffic goes on after the close while `tracing()`,
with `tick()` between units of work, through two phases, each opened and
closed behind a synchronise, so that the device work in a trace is that of
the units dispatched in between:

  1. `trace_seconds` of the device's activity alone (light: the host's
     operations are not recorded, which would slow the host and swell the
     device's idle share). From it: `busy_s`, the union of the device's
     kernel, copy and fill intervals; each kernel's device seconds by name;
     the growth of the traffic driver's counters (the work dispatched,
     which the rooflines divide).
  2. after `settle_seconds` of the traffic untraced (so that the first
     phase's export, which holds up the host, and the backlog it leaves
     are over), `gap_seconds` of host and device activity, for the names
     of the ten longest idle gaps on the device: each is named by the host
     operation that overlapped it most (the shortest of the ties: the most
     specific).

Each phase's profile is exported as it closes, to a fixed file under the
run's temporary directory, read and deleted: in the tail, after the
window (a profile held past the next one's start loses its device
times). The work a second of each phase against the window's is what the
tracer costs (`TraceSummary.rates`, printed to standard error).
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
TRACE_FILE = "zutis_benchmark_trace.json"
NAME_CHARS = 120
WORK = "flops"  # the counter whose growth a second says what the tracer costs


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    idle_gaps: List[list]
    # the traffic driver's counters' growth inside it: launches, and the
    # bounds of the work dispatched
    counters: Dict[str, float] = field(default_factory=dict)
    # the work a second (counter WORK) in the window and in each phase
    rates: Dict[str, float] = field(default_factory=dict)

    def seconds_matching(self, patterns) -> float:
        rx = [re.compile(p) for p in patterns]
        return sum(s for name, s in self.kernel_s.items()
                   if any(r.search(name) for r in rx))

    def device_ops(self, top: int = 10) -> List[list]:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:NAME_CHARS], s] for name, s in ops]


@dataclass
class _Phase:
    prof: object
    host: bool
    t0: float
    before: Dict[str, float]
    open: bool = True
    seconds: float = 0.0
    after: Dict[str, float] = field(default_factory=dict)
    events: list = field(default_factory=list)


class Window:
    """The measured window of `seconds`, then the traced tail."""

    def __init__(self, seconds: float, trace: bool = False,
                 trace_seconds: float = 2.0, gap_seconds: float = 1.0,
                 settle_seconds: float = 1.5,
                 sync: Callable[[], None] = lambda: None,
                 counters: Callable[[], Dict[str, float]] = dict,
                 guard=None):
        """`guard`, a lock the program's dispatch holds (a server's worker
        thread), is held while a trace opens or closes, so that the trace
        holds whole units."""
        self.seconds, self.trace = seconds, trace
        self.guard = guard if guard is not None else contextlib.nullcontext()
        self.trace_seconds, self.gap_seconds = trace_seconds, gap_seconds
        self.settle_seconds = settle_seconds
        self._settle_until: Optional[float] = None
        self.sync, self.counters = sync, counters
        self.t0 = self.t_end = None
        self._at_start: Dict[str, float] = {}
        self._at_close: Dict[str, float] = {}
        self._phases: List[_Phase] = []
        self.summary: Optional[TraceSummary] = None

    def start(self) -> None:
        self._at_start = self.counters()
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def measuring(self) -> bool:
        return self.elapsed() < self.seconds

    def close(self) -> None:
        """End the window (the caller has synchronised where its metric
        needs it); with tracing on, the traced tail opens."""
        self.t_end = time.perf_counter()
        self._at_close = self.counters()
        if self.trace:
            self._begin(host=False)

    def window_s(self) -> float:
        return self.t_end - self.t0

    def tracing(self) -> bool:
        """Whether the traced tail wants more units of work."""
        return bool(self._phases) and (self._phases[-1].open
                                       or self._settle_until is not None)

    def tick(self) -> None:
        if not self.tracing():
            return
        now = time.perf_counter()
        if self._settle_until is not None:
            if now >= self._settle_until:
                self._settle_until = None
                self._begin(host=True)
            return
        ph = self._phases[-1]
        limit = self.gap_seconds if ph.host else self.trace_seconds
        if now - ph.t0 >= limit:
            self._stop(ph)
            if not ph.host:
                self._settle_until = time.perf_counter() + self.settle_seconds

    def finish(self) -> None:
        """After the tail's last unit (the caller has synchronised): a
        trace still open ends, and the traces are summarised."""
        if self.t_end is None:
            self.close()
        self._settle_until = None
        if self._phases and self._phases[-1].open:
            self._stop(self._phases[-1])
        if self._phases:
            self._read()

    def _begin(self, host: bool) -> None:
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if host or not torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CPU)
        prof = torch.profiler.profile(activities=acts)
        with self.guard:
            self.sync()
            before = self.counters()
            prof.start()
            self._phases.append(_Phase(prof, host, time.perf_counter(),
                                       before))

    def _stop(self, ph: _Phase) -> None:
        with self.guard:
            self.sync()
            ph.seconds = time.perf_counter() - ph.t0
            ph.prof.stop()
            ph.after = self.counters()
            ph.open = False
        ph.events, ph.prof = _events(ph.prof), None

    def _rate(self, before, after, seconds) -> float:
        return (after.get(WORK, 0.0) - before.get(WORK, 0.0)) / max(
            seconds, 1e-9)

    def _read(self) -> None:
        device = self._phases[0]
        counters = {k: device.after[k] - device.before.get(k, 0)
                    for k in device.after}
        self.summary = summarise(device.events, device.seconds, counters)
        rates = {"window": self._rate(self._at_start, self._at_close,
                                      self.window_s()),
                 "device_trace": self._rate(device.before, device.after,
                                            device.seconds)}
        if len(self._phases) > 1:
            host = self._phases[1]
            self.summary.idle_gaps = name_gaps(host.events)
            rates["host_trace"] = self._rate(host.before, host.after,
                                             host.seconds)
        self.summary.rates = rates
        self._phases = []
        if rates["window"] > 0:
            print("trace: work a second against the window's: " + ", ".join(
                f"{k} {v / rates['window']:.4f}" for k, v in rates.items()),
                file=sys.stderr)


def _events(prof) -> list:
    path = os.path.join(tempfile.gettempdir(), TRACE_FILE)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def _merged(intervals: List[tuple]) -> List[list]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _device_intervals(events: list):
    dev, kernel_s = [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e.get("cat", "") in DEVICE_CATS:
            ts, dur = float(e["ts"]), float(e["dur"])
            dev.append((ts, ts + dur))
            name = e.get("name", "?")
            kernel_s[name] = kernel_s.get(name, 0.0) + dur * 1e-6
    return _merged(dev), kernel_s


def summarise(events: list, window_s: float,
              counters: Dict[str, float]) -> TraceSummary:
    busy, kernel_s = _device_intervals(events)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    return TraceSummary(window_s=window_s, busy_s=busy_s, kernel_s=kernel_s,
                        idle_gaps=[], counters=counters)


def name_gaps(events: list, top: int = 10) -> List[list]:
    """The `top` longest idle gaps between device intervals, each named by
    the host operation that overlapped it most."""
    busy, _ = _device_intervals(events)
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("name", "?")) for e in events
            if e.get("ph") == "X" and "dur" in e
            and e.get("cat", "") in HOST_CATS]
    gaps = sorted(((b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])
                   if b1[0] > b0[1]), key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
        best = None
        for h0, h1, name in host:
            over = min(b, h1) - max(a, h0)
            if over <= 0:
                continue
            key = (over, -(h1 - h0))
            if best is None or key > best[0]:
                best = (key, name)
        named.append([(best[1] if best else "no host op")[:NAME_CHARS],
                      (b - a) * 1e-6])
    return named
