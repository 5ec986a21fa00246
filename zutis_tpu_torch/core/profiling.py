"""Tracing, spans and numeric guards (the port of
zutis_tpu/core/profiling.py).

  - `trace(log_dir)`: a context manager around `torch.profiler` (host and,
    on a card, device activity) that writes a Chrome trace,
    `<log_dir>/trace.json`, when it exits; `Trainer.fit(profile_dir=...)`
    traces a window of training steps with it.
  - `span(name, parent=None, device=False, **ids)`: a context manager that
    marks a stretch of the program: the training step's upload, forward,
    criterion, matcher, backward and optimiser, the server's batches and
    their upload and finish. `open_span` / `close_span` are the same span
    as a pair of calls, for one that ends on another thread (a request's
    wait in the server's queue). `annotate` is `span`.
  - `record_spans(on)`, `sessions()`, `clear()`: the span recorder (below).
  - `enable_debug_nans()`: autograd's anomaly detection, which raises at
    the first backward op that produces NaN.
  - `check_finite(tree, where)`: a guard over a module's parameters or a
    nested dict, list or tuple of tensors and arrays (bf16 included);
    raises NonFiniteError with the offending leaf's path. It reads the
    values, so on a card it waits for them. The training loop's per-step
    loss guard raises NonFiniteError itself (engine/trainer.py).

**The span recorder.** Spans are recorded while `torch.profiler` runs
(`trace`, or any profile of the caller's) and while `record_spans(True)`
holds; otherwise a span site checks two flags and returns a shared no-op,
and nothing is allocated, recorded or entered. Each span keeps its name,
its host start and end (`time.perf_counter_ns`), the id of the span that
caused it (the span open around it on its thread, or the `parent` given),
the ids given (`rid` a request, `bid` a batch, `cancelled`) and, with
`device=True` (callers pass whether their tensors lie on a card), a pair of
timing CUDA events recorded on the current stream at its open and close,
resolved only when `sessions()` reads them. While the profiler runs, a
span opened with `span` also enters `torch.profiler.record_function`, so
that it shows in the exported trace as a `user_annotation`.

Each stretch of recording is a numbered session: a new one begins at the
first span opened after a span site has seen recording off (or after a
`trace` or `record_spans(False)` ended one). A session holds at most
`MAX_SPANS` spans and counts those it drops, and keeps one anchor, a
`(perf_counter_ns, time_ns)` pair read together, which `trace_interval`
uses to put a span on a Chrome trace's clock. A span that ends after its
session has ended (recording seen off, or a later session begun) is marked
`outlived`: its end measures whatever held the thread past the session
(a profile's stop and export), and `span_ms` leaves it out, as it leaves
out cancelled ones. Spans are per process: on a mesh each rank records
its own.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

TRACE_FILE = "trace.json"
MAX_SPANS = 1 << 16  # a session's spans; later ones are counted as dropped


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        _end_session()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


# ---------------- spans ----------------

# torch.profiler's own flag, set while any profile runs
_profiler = torch.autograd.profiler
_forced = False  # record_spans(True)
_saw_off = True  # recording seen off since the current session began
_lock = threading.Lock()
_sessions: List["_Session"] = []
_numbers = itertools.count()
_span_ids = itertools.count(1)
_local = threading.local()  # .stack: the spans `span` opened on this thread


class _Session:
    def __init__(self, number: int):
        p0 = time.perf_counter_ns()
        real = time.time_ns()
        self.anchor = ((p0 + time.perf_counter_ns()) // 2, real)
        self.number = number
        self.spans: List[Span] = []
        self.dropped = 0


class Span:
    """A recorded span; leaving its `with`, or `close_span`, ends it."""
    __slots__ = ("name", "sid", "parent", "ids", "t0", "t1", "events",
                 "annotation", "stacked", "session")

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        close_span(self)
        return False


class _NoSpan:
    """What a span site gets while nothing records: it does nothing."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


def record_spans(on: bool = True) -> None:
    """Record spans whether or not a profiler runs (`on`), or only while
    one runs. Turning it off ends the session."""
    global _forced
    _forced = bool(on)
    if not on:
        _end_session()


def _end_session() -> None:
    global _saw_off
    _saw_off = True


def _session() -> _Session:
    global _saw_off
    if _saw_off:
        with _lock:
            if _saw_off:
                _sessions.append(_Session(next(_numbers)))
                _saw_off = False
    return _sessions[-1]


def _open(name: str, parent, device: bool, ids: dict,
          stacked: bool) -> Optional[Span]:
    session = _session()
    if len(session.spans) >= MAX_SPANS:
        session.dropped += 1
        return None
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    s = Span()
    s.name, s.sid, s.ids, s.t1 = name, next(_span_ids), ids, None
    if parent is None and stack:
        parent = stack[-1]
    s.parent = None if parent is None else parent.sid
    s.stacked, s.annotation, s.events = stacked, None, None
    s.session = session
    s.t0 = time.perf_counter_ns()
    if stacked:
        stack.append(s)
        if _profiler._is_profiler_enabled:
            s.annotation = torch.profiler.record_function(name)
            s.annotation.__enter__()
    if device:
        s.events = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        s.events[0].record()
    session.spans.append(s)
    return s


def span(name: str, parent=None, device: bool = False, **ids):
    """A span around a `with` block on this thread (module docstring); a
    shared no-op while nothing records."""
    global _saw_off
    if not (_forced or _profiler._is_profiler_enabled):
        _saw_off = True
        return _NO_SPAN
    return _open(name, parent, device, ids, stacked=True) or _NO_SPAN


annotate = span


def open_span(name: str, parent=None, device: bool = False,
              **ids) -> Optional[Span]:
    """A span that `close_span` ends, on any thread; None while nothing
    records. It enters no `record_function` (the profiler pairs an
    annotation's ends on one thread), and spans opened inside it on this
    thread do not take it as their parent."""
    global _saw_off
    if not (_forced or _profiler._is_profiler_enabled):
        _saw_off = True
        return None
    return _open(name, parent, device, ids, stacked=False)


def close_span(s: Optional[Span], **ids) -> None:
    """End `s` (None, or a span already ended: nothing), adding `ids`, and
    `outlived` if its session has ended (module docstring)."""
    global _saw_off
    if s is None or s.t1 is not None:
        return
    if not (_forced or _profiler._is_profiler_enabled):
        _saw_off = True
    if _saw_off or not _sessions or _sessions[-1] is not s.session:
        ids["outlived"] = True
    if s.events is not None:
        s.events[1].record()
    if s.annotation is not None:
        s.annotation.__exit__(None, None, None)
        s.annotation = None
    if s.stacked:
        _local.stack.remove(s)
    s.ids.update(ids)
    s.t1 = time.perf_counter_ns()


def clear() -> None:
    """Forget every session; the next span opens a new one."""
    with _lock:
        _sessions.clear()
    _end_session()


def sessions() -> List[Dict[str, Any]]:
    """Each session as {"number", "anchor": (perf_counter_ns, time_ns),
    "dropped", "spans"}, a span as {"name", "id", "parent", "ids",
    "t0_ns", "t1_ns" (None while open), "device_ms" (None without device
    events or while open)}. Waits for the card where a span has device
    events."""
    with _lock:
        held = list(_sessions)
    if any(s.events is not None for ses in held for s in ses.spans):
        torch.cuda.synchronize()
    out = []
    for ses in held:
        spans = []
        for s in list(ses.spans):
            closed = s.t1 is not None
            device_ms = (s.events[0].elapsed_time(s.events[1])
                         if closed and s.events is not None else None)
            spans.append({"name": s.name, "id": s.sid, "parent": s.parent,
                          "ids": dict(s.ids), "t0_ns": s.t0,
                          "t1_ns": s.t1 if closed else None,
                          "device_ms": device_ms})
        out.append({"number": ses.number, "anchor": ses.anchor,
                    "dropped": ses.dropped, "spans": spans})
    return out


def first_session(holding: str) -> Optional[Dict[str, Any]]:
    """The first of `sessions()` that holds a span named `holding`."""
    for ses in sessions():
        if any(s["name"] == holding for s in ses["spans"]):
            return ses
    return None


def span_ms(session: Dict[str, Any], name: str,
            device: bool = False) -> Optional[List[float]]:
    """The ms of each ended span named `name` in `session` (one of
    `sessions()`) that was neither cancelled nor outlived its session: its
    host interval, or with `device` its device interval (None if any of
    them has none)."""
    done = [s for s in session["spans"] if s["name"] == name
            and s["t1_ns"] is not None and not s["ids"].get("cancelled")
            and not s["ids"].get("outlived")]
    if not device:
        return [(s["t1_ns"] - s["t0_ns"]) * 1e-6 for s in done]
    if any(s["device_ms"] is None for s in done):
        return None
    return [s["device_ms"] for s in done]


def trace_interval(s: Dict[str, Any], session: Dict[str, Any],
                   base_ns: int) -> Tuple[float, float]:
    """(ts, dur) in µs of an ended span on the clock of a Chrome trace whose
    `baseTimeNanoseconds` is `base_ns`: the trace's `ts` is the realtime
    clock's ns less that base, over 1000."""
    perf, real = session["anchor"]
    ts = (real + s["t0_ns"] - perf - base_ns) * 1e-3
    return ts, (s["t1_ns"] - s["t0_ns"]) * 1e-3


def enable_debug_nans(on: bool = True) -> None:
    torch.autograd.set_detect_anomaly(on)


class NonFiniteError(RuntimeError):
    pass


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, torch.nn.Module):
        for name, p in tree.named_parameters():
            yield f"{path}{name}", p
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}{i}/")
    else:
        yield path.rstrip("/"), tree


def check_finite(tree: Any, where: str = "") -> None:
    for path, leaf in _leaves(tree):
        if torch.is_tensor(leaf):
            if leaf.is_floating_point() and not bool(
                    torch.isfinite(leaf.detach()).all()):
                raise NonFiniteError(
                    f"non-finite value at {where or 'unknown'}: leaf {path!r}")
            continue
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f" and not np.all(np.isfinite(arr)):
            raise NonFiniteError(
                f"non-finite value at {where or 'unknown'}: leaf {path!r}")
