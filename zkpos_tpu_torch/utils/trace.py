"""Spans and counters inside the program, kept in memory.

    with trace.span("msm", curve="g1") as sp:      # a span on this thread
        trace.count("entries", n)                  # the innermost span's
        with trace.wait("readback"):               # a host read of the card
            pt = t.cpu()
        sp.set(chunks=2)                           # more attributes

A span records its name, its parent (the span open on this thread when it
opened), its root (the id of the outermost span, shared by every span of
one prove or one build), its start and end on time.perf_counter(), its
attributes, counters and waits.  A span opened with ``device=`` a CUDA
device also records a pair of CUDA events on that device's current
stream; they are never waited on while the program
runs, and records() resolves them to device seconds (``device_s``).
trace.wait(site) adds one host sync to the innermost span, with the host
seconds it blocked and the time it returned.

Tracing is on while a torch.profiler session records, inside
trace.capture(), or when ZKPOS_TRACE was set (to anything but "" or "0")
as the module was imported: then every record is written at exit as one
JSON object a line, to stderr when the value is 1, else appended to the
file it names.  Off, span() and
wait() return one shared object that does nothing: no record, no event,
no synchronize, no clock read.  The store keeps the last KEEP_ROOTS
(1,024) roots with their spans: a long-running process loses the older
ones, and a process killed before its exit writes nothing.

No profiler range is opened for a span: under CUPTI a range comes back as
a device-side annotation, which a trace reader would count as device work.
"""

from __future__ import annotations

import atexit
import collections
import itertools
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

import torch

KEEP_ROOTS = 1024
ENV = "ZKPOS_TRACE"


class _Off:
    """The span and the wait of tracing off: does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


OFF = _Off()


class _Span:
    __slots__ = ("tracer", "record", "stream", "events")

    def __init__(self, tracer, record, stream):
        self.tracer, self.record, self.stream = tracer, record, stream
        self.events = None

    def __enter__(self):
        self.tracer._stack().append(self.record)
        if self.stream is not None:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(self.stream)
            self.events = (start, end)
        self.record["start"] = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.record["end"] = time.perf_counter()
        if self.events is not None:
            self.events[1].record(self.stream)
            self.record["_ev"] = self.events + (self.stream.device,)
        self.tracer._stack().pop()
        return False

    def set(self, **attrs):
        self.record["attrs"].update(attrs)

    @property
    def seconds(self) -> float:
        return self.record["end"] - self.record["start"]


class _Wait:
    __slots__ = ("record", "site", "t0")

    def __init__(self, record, site):
        self.record, self.site = record, site

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t = time.perf_counter()
        self.record["waits"].append([self.site, t - self.t0, t])
        return False


class _Capture:
    __slots__ = ("tracer",)

    def __init__(self, tracer):
        self.tracer = tracer

    def __enter__(self):
        self.tracer._local.captures = self.tracer._captures() + 1
        return self

    def __exit__(self, *exc):
        self.tracer._local.captures -= 1
        return False


class Tracer:
    """The store of spans: the last KEEP_ROOTS roots, each a list of its
    records in the order they opened.  With a `target` ("1": stderr, else
    a file path) tracing is always on and export() writes there."""

    def __init__(self, target: Optional[str] = None):
        self.target = target
        self._roots = collections.deque(maxlen=KEEP_ROOTS)
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._exporting = False

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _captures(self) -> int:
        return getattr(self._local, "captures", 0)

    def enabled(self) -> bool:
        return (self._captures() > 0 or torch.autograd._profiler_enabled()
                or self.target is not None)

    def capture(self):
        """Tracing on, on this thread, inside the block."""
        return _Capture(self)

    def span(self, name: str, device=False, **attrs):
        """A span of `name`: recorded when a span of this thread is open
        or tracing is on.  `device`: a torch.device (events when it is a
        CUDA device) or False."""
        stack = self._stack()
        if not stack and not self.enabled():
            return OFF
        rid = next(self._ids)
        rec = {"name": name, "id": rid,
               "parent": stack[-1]["id"] if stack else None,
               "root": stack[0]["root"] if stack else rid,
               "start": None, "end": None, "attrs": attrs, "counts": {},
               "waits": [], "device_s": None}
        if stack:
            stack[0]["_records"].append(rec)
        else:
            rec["_records"] = [rec]
            self._roots.append(rec["_records"])
            if self.target is not None:
                self._export_at_exit()
        return _Span(self, rec, self._stream(device))

    @staticmethod
    def _stream(device):
        if device is False or device.type != "cuda":
            return None
        return torch.cuda.current_stream(device)

    def count(self, name: str, n: int = 1) -> None:
        """Add n to counter `name` of the innermost open span."""
        stack = self._stack()
        if stack:
            counts = stack[-1]["counts"]
            counts[name] = counts.get(name, 0) + n

    def wait(self, site: str):
        """Around a host read of the card: one host sync at `site` in the
        innermost open span, with the seconds it blocked."""
        stack = self._stack()
        return _Wait(stack[-1], site) if stack else OFF

    def records(self) -> List[Dict]:
        """Every finished span of the kept roots, as plain dicts (root
        first, then its spans in the order they opened), each device span's
        events resolved to device seconds after one synchronize."""
        roots = list(self._roots)
        pending = [r for recs in roots for r in recs
                   if "_ev" in r and r["end"] is not None]
        if pending:
            for dev in {r["_ev"][2] for r in pending}:
                torch.cuda.synchronize(dev)
            for r in pending:
                start, end, _ = r.pop("_ev")
                r["device_s"] = start.elapsed_time(end) / 1e3
        return [{k: v for k, v in r.items() if k != "_records"}
                for recs in roots for r in list(recs)
                if r["end"] is not None]

    def _export_at_exit(self) -> None:
        with self._lock:
            if self._exporting:
                return
            self._exporting = True
        atexit.register(self.export)

    def export(self) -> None:
        """Write every record as a JSON line to the target."""
        if self.target is None:
            return
        lines = "".join(json.dumps(r, default=str) + "\n"
                        for r in self.records())
        if self.target == "1":
            sys.stderr.write(lines)
            sys.stderr.flush()
        else:
            with open(self.target, "a") as f:
                f.write(lines)


def _env_target() -> Optional[str]:
    v = os.environ.get(ENV, "")
    return None if v in ("", "0") else v


TRACER = Tracer(target=_env_target())
span = TRACER.span
count = TRACER.count
wait = TRACER.wait
capture = TRACER.capture
records = TRACER.records
enabled = TRACER.enabled
