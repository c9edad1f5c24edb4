"""Spans and counters inside the port, on the profiler's clock.

What the program's own layers did, for the benchmark's per-layer readers
and the operator's ``SVT_LOG=debug`` summary (``app.py``):

- ``span(name)``: a host span, stamped with ``time.perf_counter_ns()``.
- ``device_span(name, device)``: a pair of CUDA events on the device's
  current stream; its length is the device time between them, read
  lazily (``records()`` waits for the events), and its start is the host
  time the first was enqueued.  It yields an object whose ``end`` is the
  second event (None when nothing is recorded).  While a profiler is
  active, a marker kernel (``MARK``, torch's one-thread ``spin_kernel``
  of no cycles) runs on the stream just before the first event, and the
  record's ``n`` says which: the n-th since recording started.  That
  marker's end on the profiler's device timeline is where the span
  starts there, so a reader can take the device events inside it
  without mapping host stamps onto the device's clock.
- ``count(name, n)``: adds n to a counter.  Counters are always on; while
  recording, each add is also kept as a stamped sample, so a reader can
  sum a window.

Spans are recorded only while a ``torch.profiler`` is active or after
``enable()``.  Off, a span costs one flag read and a shared no-op context
(under a microsecond); ``torch.profiler.record_function`` alone costs
10-20 us a call even with the profiler off, so it is never called then.
On, each host span is also mirrored as ``svt.<name>`` on the profiler's
CPU timeline, as a function-scope event: a user-scope ``record_function``
gets a copy on the device's timeline (``gpu_user_annotation``), which a
reader of the device events would count as device work.  Spans on
threads the profiler did not start (the coder pool's) are recorded but
have no mirror.  ``always=True`` records a span whatever the flag says,
for the few a process makes at set-up (``setup.build``).

The profiler stamps its events in ns since the epoch (``time.time_ns()``'s
clock); ``to_profiler_ns`` maps a ``perf_counter_ns`` stamp onto that axis
with an offset taken as a back-to-back pair of the two clocks when
recording starts.  The buffer keeps the newest ``size`` records and counts
those it dropped.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import NamedTuple

import torch
import torch.autograd.profiler as _prof

# the name of the kernel that marks a device span's start on the
# profiler's device timeline (at::cuda::sleep's)
MARK = "spin_kernel"


class Record(NamedTuple):
    """kind: "host" or "device" span, or "count" (a counter sample:
    start_ns == end_ns, n the amount added).  For a device span, n > 0
    where the n-th MARK kernel since recording started ran on the stream
    just before it.  thread: the host span's thread
    (``threading.get_ident()``; 0 for the other kinds)."""
    kind: str
    name: str
    start_ns: int
    end_ns: int
    n: int = 0
    thread: int = 0


def _clock_offset() -> int:
    """time.time_ns() - time.perf_counter_ns(), read back to back."""
    return time.time_ns() - time.perf_counter_ns()


def _mirror(name: str):
    """A context that puts `name` on the profiler's CPU timeline (a
    function-scope event)."""
    return torch._C._profiler._RecordFunctionFast(name)


class _Off:
    """The context a span returns when nothing is recorded."""
    __slots__ = ()
    end = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "name", "t0", "mirror")

    def __init__(self, rec, name):
        self.rec, self.name, self.mirror = rec, name, None

    def __enter__(self):
        if _prof._is_profiler_enabled:
            self.mirror = _mirror("svt." + self.name)
            self.mirror.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.mirror is not None:
            self.mirror.__exit__(*exc)
        self.rec.add(Record("host", self.name, self.t0, t1, 0,
                            threading.get_ident()))
        return False


class _DeviceSpan:
    __slots__ = ("rec", "name", "stream", "t0", "mark", "start", "end")

    def __init__(self, rec, name, device):
        self.rec, self.name = rec, name
        self.stream = torch.cuda.current_stream(device)
        self.end = None

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        self.mark = 0
        if _prof._is_profiler_enabled:
            with torch.cuda.stream(self.stream):
                torch.cuda._sleep(0)        # the MARK kernel
            self.mark = self.rec.next_mark()
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        self.end = torch.cuda.Event(enable_timing=True)
        self.end.record(self.stream)
        self.rec.add(self)          # a Record once records() resolves it
        return False

    def resolve(self) -> Record:
        self.end.synchronize()
        dt = int(round(self.start.elapsed_time(self.end) * 1e6))
        return Record("device", self.name, self.t0, self.t0 + dt,
                      self.mark)


class Recorder:
    """The bounded buffer of records, the counters and the clock offset."""

    def __init__(self, size: int = 1 << 16):
        self.enabled = False
        self.dropped = 0
        self.offset = _clock_offset()
        self.idle = True            # nothing recorded since the last span
        self.marks = 0              # MARK kernels since recording started
        self._buf = deque(maxlen=size)
        self._counts = {}
        self._lock = threading.Lock()

    def recording(self) -> bool:
        return self.enabled or _prof._is_profiler_enabled

    def _start(self) -> None:
        self.idle = False
        self.offset = _clock_offset()
        self.marks = 0

    def next_mark(self) -> int:
        with self._lock:
            self.marks += 1
            return self.marks

    def span(self, name: str, always: bool = False):
        if self.enabled or _prof._is_profiler_enabled or always:
            if self.idle:
                self._start()
            return _Span(self, name)
        self.idle = True
        return _OFF

    def device_span(self, name: str, device):
        if (self.enabled or _prof._is_profiler_enabled) and \
                torch.device(device).type == "cuda":
            return _DeviceSpan(self, name, device)
        return _OFF

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n
        if self.enabled or _prof._is_profiler_enabled:
            t = time.perf_counter_ns()
            self.add(Record("count", name, t, t, n))

    def add(self, rec) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(rec)

    def records(self) -> list:
        """Every record kept, oldest first; device spans wait for their
        events and come back with end_ns = start_ns + the device time."""
        with self._lock:
            out = list(self._buf)
        return [r.resolve() if isinstance(r, _DeviceSpan) else r
                for r in out]

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def to_profiler_ns(self, t_ns: int) -> int:
        return t_ns + self.offset

    def summary(self) -> dict:
        """{span name: (count, mean ms)} over the records kept."""
        acc = {}
        for r in self.records():
            if r.kind != "count":
                n, s = acc.get(r.name, (0, 0))
                acc[r.name] = (n + 1, s + r.end_ns - r.start_ns)
        return {k: (n, s / n / 1e6) for k, (n, s) in acc.items()}


_REC = Recorder()


def span(name: str, always: bool = False):
    return _REC.span(name, always)


def device_span(name: str, device):
    return _REC.device_span(name, device)


def count(name: str, n: int = 1) -> None:
    _REC.count(name, n)


def recording() -> bool:
    return _REC.recording()


def enable(on: bool = True) -> None:
    """Record whether or not a profiler is active (off: only while one
    is)."""
    _REC.enabled = on
    if on:
        _REC._start()


def records() -> list:
    return _REC.records()


def counters() -> dict:
    return _REC.counters()


def dropped() -> int:
    """Records the full buffer dropped."""
    return _REC.dropped


def to_profiler_ns(t_ns: int) -> int:
    """A perf_counter_ns stamp on the profiler's axis (ns since the
    epoch, as kineto's start_ns())."""
    return _REC.to_profiler_ns(t_ns)


def summary() -> dict:
    return _REC.summary()
