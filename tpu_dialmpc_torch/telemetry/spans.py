"""Spans at the boundaries of the port's layers, kept in memory.

One process-wide tracer, off until `enable()`, as a global tracer provider
is; `enable(device=False)` turns on its host spans alone.  While it is off
`span()` returns one shared no-op context and nothing is recorded, so the
program runs the code and captures the graphs it runs untraced.

- `span(name)` is a host span: two reads of `time.perf_counter`, and while a
  `torch.profiler` session is active also a `record_function` range, so the
  trace puts it on the device records' clock.  A host span's path is its
  name (`setup/env`, `graph/replay`: the name carries its layer).
- `span(name, device=d)` is a device span for work on `d`.  On a CUDA
  device it records two `torch.cuda.Event(enable_timing=True,
  external=True)` on the current stream: recorded during stream capture
  they become event-record nodes of the CUDA graph and replay with it.  On
  the CPU, whose ops are synchronous, its marks are host clock reads.  Its
  path joins the names of the device spans it sits in (`rollout/ctrl`).
- `follows=True` lets a device span open on a mark it shares, in place of
  a new one: its parent's start, where it is the first child of a device
  span, or the end of its previous sibling, where that sibling closed
  last, under the same device span or, at the top level, under its own
  name; each only where it is the last mark on the stream.  The call site
  promises that no device work is enqueued between the two.  So a horizon
  step's ctrl, physics and reward cost three marks, not six.
- Where a span's marks were recorded during a capture (`capturing()`), the
  captured unit owns them (`Owned`); each replay (`replaying(owned)`) marks
  them pending, and `collect()` reads them.  A CUDA graph's events hold its
  last replay's times only: collect after every replay to read each one
  (`collect` returns how many replays it could not read).  A stand-in graph
  that replays by running the Python again stamps the owned marks in the
  order the capture made them.  `held()` holds device spans off (a
  planner's own graphs are captured so, `planner/capture.py`: their
  replays carry no event, and a second graph per unit carries the spans).
- `collect()` waits for the device and adds the device seconds of every
  eager device span and replay since the last collect; `summary()` gives,
  per path, the count and host seconds (and self seconds: less the host
  spans inside) of host spans, and the count and device seconds of device
  spans; `records()` the spans as their Python ran (name, path, parent,
  start and end on the host clock), in the order they opened; `reset()`
  forgets all of it.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

import torch

MAX_RECORDS = 1 << 16


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class Record:
    """One span as its Python ran: `parent` is the path of the span it sat
    in (None at the top), `start`/`end` host clock seconds."""

    __slots__ = ("name", "path", "parent", "device", "start", "end")

    def __init__(self, name, path, parent, device, start):
        self.name, self.path, self.parent, self.device = name, path, parent, device
        self.start, self.end = start, None

    def __repr__(self):
        return f"Record({self.path!r}, parent={self.parent!r}, device={self.device})"


class _HostMark:
    """A device span's mark off the card: a host clock read."""

    __slots__ = ("t",)

    def __init__(self):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()


def _elapsed(start, end) -> float:
    if isinstance(start, _HostMark):
        return end.t - start.t
    return 1e-3 * start.elapsed_time(end)


class Owned:
    """A captured unit's device spans: its marks in the order the capture
    recorded them, and (path, start mark, end mark) per span."""

    def __init__(self):
        self.marks, self.entries = [], []


class _Replay:
    """A stand-in replay that runs the unit's Python again: each new mark is
    the owned one at the same place."""

    def __init__(self, owned: Owned):
        self.owned, self.i = owned, 0

    def take(self):
        m = self.owned.marks[self.i]
        self.i += 1
        return m


class _Span:
    __slots__ = ("tr", "name", "device", "follows", "path", "rec", "child_s", "rf",
                 "stream", "start", "up")

    def __init__(self, tr, name, device, follows):
        self.tr, self.name, self.device, self.follows = tr, name, device, follows

    def __enter__(self):
        tr = self.tr
        stack = tr._stack()
        parent = stack[-1].path if stack else None
        if self.device is None:
            self.path, self.child_s, self.rf = self.name, 0.0, None
            if torch.autograd.profiler._is_profiler_enabled:
                self.rf = torch.profiler.record_function(self.name)
                self.rf.__enter__()
        else:
            self.up = next((s for s in reversed(stack) if s.device is not None), None)
            self.path = self.name if self.up is None else f"{self.up.path}/{self.name}"
            self.stream = (torch.cuda.current_stream(self.device)
                           if self.device.type == "cuda" else None)
            self.start = tr._open(self)
        stack.append(self)
        self.rec = Record(self.name, self.path, parent, self.device is not None,
                          time.perf_counter())
        tr._records.append(self.rec)
        return self

    def __exit__(self, *exc):
        tr = self.tr
        t1 = time.perf_counter()
        self.rec.end = t1
        stack = tr._stack()
        stack.pop()
        if self.device is None:
            if self.rf is not None:
                self.rf.__exit__(*exc)
            tr._host(self.path, t1 - self.rec.start, self.child_s, stack)
        else:
            tr._close(self)
        return False


class Tracer:
    """The tracer's state (module docstring); `TRACER` is the process's."""

    def __init__(self):
        self.on = self.device = False
        self._local = threading.local()
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self._host_stats: Dict[str, list] = {}
            self._device_stats: Dict[str, list] = {}
            self._pending = []  # eager device spans: (path, start, end)
            self._replays = {}  # id(owned) -> [owned, replays since the last collect]
            self._records = collections.deque(maxlen=MAX_RECORDS)

    # -- the thread's open spans and its last mark --------------------
    def _stack(self) -> list:
        loc = self._local
        if not hasattr(loc, "stack"):
            loc.stack, loc.last, loc.mode = [], None, None
        return loc.stack

    def _mark(self, sp, is_start):
        loc = self._local
        mode = loc.mode
        if isinstance(mode, _Replay):
            m = mode.take()
        else:
            m = _HostMark() if sp.stream is None else torch.cuda.Event(enable_timing=True,
                                                                       external=True)
            if mode is not None:
                mode.marks.append(m)
        m.record(sp.stream)
        loc.last = (sp.stream, m, sp, is_start)
        return m

    def _open(self, sp):
        loc = self._local
        last = loc.last
        if sp.follows and last is not None and last[0] == sp.stream:
            _, m, who, is_start = last
            if (who is sp.up is not None if is_start  # the parent's start
                    else who.up is sp.up and (sp.up is not None or who.name == sp.name)):
                loc.last = (sp.stream, m, sp, True)
                return m
        return self._mark(sp, True)

    def _close(self, sp):
        end = self._mark(sp, False)
        mode = self._local.mode
        if mode is None:
            self._pending.append((sp.path, sp.start, end))
        elif isinstance(mode, Owned):
            mode.entries.append((sp.path, sp.start, end))

    def _host(self, path, seconds, child_s, stack):
        for s in reversed(stack):
            if s.device is None:
                s.child_s += seconds
                break
        with self._lock:
            st = self._host_stats.setdefault(path, [0, 0.0, 0.0])
            st[0] += 1
            st[1] += seconds
            st[2] += seconds - child_s

    # -- the public interface ------------------------------------------
    def span(self, name: str, device: Optional[torch.device] = None, follows: bool = False):
        if device is None:
            return _Span(self, name, None, follows) if self.on else NOOP
        if not self.device_on():
            return NOOP
        return _Span(self, name, torch.device(device), follows)

    def device_on(self) -> bool:
        """Whether device spans record here (on, and not held)."""
        return self.on and self.device and getattr(self._local, "mode", None) is not _HELD

    def held(self):
        """A context in which device spans record nothing."""
        return _Mode(self, _HELD) if self.device_on() else NOOP

    def record_host(self, name: str, t0: float, t1: float):
        """A host span timed by the caller's two clock reads."""
        if not self.on:
            return
        stack = self._stack()
        rec = Record(name, name, stack[-1].path if stack else None, False, t0)
        rec.end = t1
        self._records.append(rec)
        self._host(name, t1 - t0, 0.0, stack)

    def capturing(self):
        """A context for a unit's capture: yields the `Owned` that its
        device spans go to (None while the tracer is off)."""
        return _Mode(self, Owned()) if self.on else NOOP

    def replaying(self, owned: Optional[Owned]):
        """A context around one replay of a unit that owns `owned`."""
        if not self.on or owned is None or not owned.entries:
            return NOOP
        return _Mode(self, _Replay(owned))

    def collect(self) -> int:
        """Wait for the device; add the device seconds of every eager device
        span and replay since the last collect.  Returns the replays whose
        times a later replay of the same graph overwrote (not read)."""
        with self._lock:
            entries, self._pending = self._pending, []
            replays, self._replays = list(self._replays.values()), {}
        unread = 0
        for owned, n in replays:
            entries += owned.entries
            unread += n - 1
        if any(not isinstance(start, _HostMark) for _, start, _ in entries):
            torch.cuda.synchronize()
        with self._lock:
            for path, start, end in entries:
                st = self._device_stats.setdefault(path, [0, 0.0])
                st[0] += 1
                st[1] += _elapsed(start, end)
        return unread

    def summary(self) -> Dict[str, dict]:
        with self._lock:
            out = {p: dict(count=c, host_s=h, self_s=s)
                   for p, (c, h, s) in self._host_stats.items()}
            out.update({p: dict(count=c, device_s=d)
                        for p, (c, d) in self._device_stats.items()})
        return out

    def records(self) -> List[Record]:
        return list(self._records)


class _Mode:
    """Sets the thread's capture or replay mode for its span's marks."""

    def __init__(self, tr: Tracer, mode):
        self.tr, self.mode = tr, mode

    def __enter__(self):
        self.tr._stack()
        loc = self.tr._local
        self.saved = (loc.mode, loc.last)
        loc.mode, loc.last = self.mode, None
        return self.mode

    def __exit__(self, *exc):
        loc = self.tr._local
        loc.mode, loc.last = self.saved
        mode = self.mode
        if exc[0] is None and isinstance(mode, _Replay):
            # a CUDA graph's replay runs no Python (no mark); a stand-in's
            # runs all of the capture's
            if mode.i not in (0, len(mode.owned.marks)):
                raise RuntimeError(f"a replay made {mode.i} span marks; its capture made "
                                   f"{len(mode.owned.marks)}")
            tr = self.tr
            with tr._lock:
                tr._replays.setdefault(id(mode.owned), [mode.owned, 0])[1] += 1
        return False


_HELD = "held"  # the mode under `Tracer.held()`
TRACER = Tracer()


def enable(device: bool = True):
    """Host spans on, and device spans too unless `device` is False."""
    TRACER.on, TRACER.device = True, device


def disable():
    TRACER.on = TRACER.device = False


def enabled() -> bool:
    return TRACER.on


def span(name: str, device=None, follows: bool = False):
    """A host span, or with `device` a device span (module docstring)."""
    if not TRACER.on:
        return NOOP
    return TRACER.span(name, device, follows)


device_on = TRACER.device_on
held = TRACER.held


record_host = TRACER.record_host
capturing = TRACER.capturing
replaying = TRACER.replaying
collect = TRACER.collect
summary = TRACER.summary
records = TRACER.records
reset = TRACER.reset
