"""What a traced run records, and how the profiler's trace is read.

``Tap`` wraps module-level functions of the program (a metric names the
ones it reads): each call runs inside a ``bench.<key>`` range of
``torch.profiler.record_function`` and its arguments are kept, so a
kernel's operations and bytes can be worked out from the shapes it was
given. ``read_profile`` reads the raw events of one profiled window:

- the device's busy time: the union of every kernel, copy and set
  interval inside the window's range (``bench.window``);
- each tapped function's device time: the device operations whose launch
  (the runtime call of the same correlation id) lies inside one of its
  ``bench.<key>`` ranges;
- the device operations that took the most time, by name;
- the idle gaps, each named by the innermost host event running at its
  middle, summed by name.
"""

from __future__ import annotations

import bisect
import importlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

PREFIX = "bench."
WINDOW = PREFIX + "window"
NAME_CHARS = 96  # a device operation's name is cut to this many characters


class Tap:
    """Wrappers over module-level functions, installed until ``restore``."""

    def __init__(self) -> None:
        self.calls: Dict[str, List[Tuple[tuple, dict]]] = {}
        self._saved: List[Tuple[object, str, object]] = []

    def wrap(self, key: str, module: str, attr: str) -> None:
        if key in self.calls:
            return
        mod = importlib.import_module(module)
        real = getattr(mod, attr)
        calls = self.calls.setdefault(key, [])
        label = PREFIX + key

        def tapped(*args, **kwargs):
            calls.append((args, kwargs))
            with torch.profiler.record_function(label):
                return real(*args, **kwargs)

        setattr(mod, attr, tapped)
        self._saved.append((mod, attr, real))

    def restore(self) -> None:
        for mod, attr, real in reversed(self._saved):
            setattr(mod, attr, real)
        self._saved.clear()


class Profile(NamedTuple):
    window_ns: Tuple[int, int]
    busy_s: float
    device_s: Dict[str, float]  # tapped key -> attributed device seconds
    device_ops: List[List]  # [[name, seconds]], most time first
    idle_gaps: List[List]  # [[host activity, seconds]], most time first
    linked: int  # device operations linked to their launch
    device_ops_total: int


def _start(e) -> int:
    return int(e.start_ns())


def _end(e) -> int:
    return int(e.end_ns())


def _runtime_call(name: str) -> bool:
    """A CUDA runtime or driver API call (``cudaLaunchKernel``, ``cuLaunchKernel``)."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def read_profile(prof, top: int = 10) -> Optional[Profile]:
    """The window's readings from a finished ``torch.profiler.profile``;
    None when the trace holds no ``bench.window`` range."""
    events = prof.profiler.kineto_results.events()
    cpu, dev = [], []
    window = None
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CPU:
            if not e.is_user_annotation():  # not the device side of a range
                dev.append(e)
        else:
            cpu.append(e)
            if e.name() == WINDOW:
                window = e
    if window is None:
        return None
    w0, w1 = _start(window), _end(window)
    thread = window.start_thread_id()
    dev = [e for e in dev if _end(e) > w0 and _start(e) < w1]
    busy = _union([(max(_start(e), w0), min(_end(e), w1)) for e in dev])
    busy_s = sum(e - s for s, e in busy) / 1e9

    # each tapped function's device time
    ranges = sorted((_start(e), _end(e), e.name()[len(PREFIX):]) for e in cpu
                    if e.is_user_annotation() and e.name().startswith(PREFIX)
                    and e.name() != WINDOW)
    starts = [r[0] for r in ranges]

    def owner(t: int) -> Optional[str]:
        i = bisect.bisect_right(starts, t) - 1
        return ranges[i][2] if i >= 0 and t <= ranges[i][1] else None

    # a device operation's launch: the runtime call (cudaLaunchKernel and
    # the like) of the same CUPTI correlation id
    launches = {int(e.correlation_id()): _start(e) for e in cpu if _runtime_call(e.name())}
    device_s: Dict[str, float] = {}
    linked = 0
    for e in dev:
        t = launches.get(int(e.correlation_id()))
        if t is None:
            continue
        linked += 1
        key = owner(t)
        if key is not None:
            device_s[key] = device_s.get(key, 0.0) + (_end(e) - _start(e)) / 1e9

    by_name: Dict[str, float] = {}
    for e in dev:
        name = e.name()[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + (_end(e) - _start(e)) / 1e9
    device_ops = [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    # idle gaps, named by the innermost host event on the serving thread
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    host = sorted(((_start(e), -_end(e), e.name()) for e in cpu
                   if e.start_thread_id() == thread and w0 <= _start(e) <= w1))
    mids = sorted(((s + e) // 2, e - s) for s, e in gaps)
    idle: Dict[str, float] = {}
    stack: List[Tuple[int, str]] = []
    i = 0
    for mid, length in mids:
        while i < len(host) and host[i][0] <= mid:
            s, neg_end, name = host[i]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((-neg_end, name))
            i += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        label = stack[-1][1] if stack else "outside any host event"
        idle[label] = idle.get(label, 0.0) + length / 1e9
    idle_gaps = [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]
    return Profile((w0, w1), busy_s, device_s, device_ops, idle_gaps, linked, len(dev))
