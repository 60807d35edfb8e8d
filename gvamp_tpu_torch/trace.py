"""Program spans and counters of the port, on the profiler's clock.

One store for the port's instrumentation:

- ``SYNCS["count"]``: device values read on the host (``sync.host_bool``,
  ``sync.host_values``), an exact counter, always on;
- ``LAUNCHED["count"]``: the running total of ``ops.matvec.LAUNCHES`` (the
  per-wrapper counts), never reset, so that a span takes its change without
  summing a dict;
- the spans at the layer boundaries, recorded only while a
  ``torch.profiler`` session is active (``torch.autograd._profiler_enabled``:
  ``--profile-dir``, or a traced benchmark run).

With no profiler, ``span`` returns one shared no-op context: no record, no
clock read, no synchronise and no device work, one check per site.  A
record (``Span``) holds its name, its start and end on ``time.time_ns`` (the
clock of the profiler's own timestamps), the index of its parent in the
store (-1 for none), the sequence number of its top-level span (its
children inherit it, so the spans of one call share it), its attributes,
and the change over the span of ``SYNCS["count"]`` and
``LAUNCHED["count"]``.  Nothing goes onto the profiler's timeline (no
``record_function``, no NVTX range): a device-side annotation would read as
device activity and hide the idle gaps the spans are there to place.

A site opens a span with ``span(name, **attrs)`` or wraps a function in
``spanned(name, **attrs)``; ``annotate`` adds what a function learns at its
end (a solve's steps).  ``spans()`` returns the records, ``ranges()`` their
(start_ns, end_ns, name) tuples, ``summary()`` the per-name totals, and
``clear()`` empties the store.  ``timed(name, device)`` is the one
synchronising span: it always times its body, between two synchronises of
``device`` (the phase timers).
"""

from __future__ import annotations

import functools
import time

import torch

SYNCS = {"count": 0}
LAUNCHED = {"count": 0}

# whether spans record now: a profiler session is active
on = torch.autograd._profiler_enabled
_records: list = []
_open: list = []
_seq = [0]


class Span:
    """One recorded span; a context manager that records itself."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "parent", "seq",
                 "index", "syncs", "launches", "_keep", "_sync", "_s0",
                 "_l0")

    def __init__(self, name: str, attrs: dict, keep: bool = True,
                 sync=None):
        self.name, self.attrs = name, attrs
        self._keep, self._sync = keep, sync
        self.start_ns = self.end_ns = None
        self.parent = self.seq = self.index = -1
        self.syncs = self.launches = 0

    def __enter__(self) -> "Span":
        if self._keep:
            if _open:
                self.parent = _open[-1].index
                self.seq = _open[-1].seq
            else:
                _seq[0] += 1
                self.seq = _seq[0]
            self.index = len(_records)
            _records.append(self)
            _open.append(self)
        if self._sync is not None:
            torch.cuda.synchronize(self._sync)
        self._s0, self._l0 = SYNCS["count"], LAUNCHED["count"]
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._sync is not None:
            torch.cuda.synchronize(self._sync)
        self.end_ns = time.time_ns()
        self.syncs = SYNCS["count"] - self._s0
        self.launches = LAUNCHED["count"] - self._l0
        if _open and _open[-1] is self:
            _open.pop()
        return False

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.attrs}, parent={self.parent}, "
                f"seq={self.seq}, syncs={self.syncs}, "
                f"launches={self.launches})")


class _Off:
    """The shared span of an untraced run: does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, /, **attrs):
    """A span of ``name`` with ``attrs`` while a profiler runs, else the
    shared no-op context."""
    if not on():
        return _OFF
    return Span(name, attrs)


def timed(name: str, device, /) -> Span:
    """A span that always times its body between two synchronises of a
    CUDA ``device`` (none for another device); recorded as ``span`` is.
    Read its ``ms`` after the body."""
    device = torch.device(device)
    return Span(name, {}, keep=on(),
                sync=device if device.type == "cuda" else None)


def annotate(name: str, /, **attrs) -> None:
    """Add attributes to the innermost open span if it is a ``name``: what
    a decorated function learns at its end (a solve's steps)."""
    if _open and _open[-1].name == name:
        _open[-1].attrs.update(attrs)


def spanned(name: str, /, **attrs):
    """Decorator: each call of the function runs inside a span of
    ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if not on():
                return fn(*args, **kw)
            with Span(name, dict(attrs)):
                return fn(*args, **kw)
        return wrapper
    return deco


def spans() -> list:
    """The records, in the order the spans opened."""
    return list(_records)


def ranges() -> list:
    """(start_ns, end_ns, name) of every closed span, on ``time.time_ns``."""
    return [(s.start_ns, s.end_ns, s.name) for s in _records
            if s.end_ns is not None]


def clear() -> None:
    """Empty the store (spans still open are no longer parents)."""
    _records.clear()
    _open.clear()


def summary(records=None) -> list:
    """Per span name, in the order of first opening: (name, count, total
    ms, self ms, syncs), where self is the total less what the span's
    children cover."""
    records = _records if records is None else records
    done = [s for s in records if s.end_ns is not None]
    child_ns = {}
    for s in done:
        if s.parent >= 0:
            child_ns[s.parent] = (child_ns.get(s.parent, 0)
                                  + s.end_ns - s.start_ns)
    rows: dict = {}
    for s in done:
        ns = s.end_ns - s.start_ns
        r = rows.setdefault(s.name, [s.name, 0, 0.0, 0.0, 0])
        r[1] += 1
        r[2] += ns / 1e6
        r[3] += (ns - child_ns.get(s.index, 0)) / 1e6
        r[4] += s.syncs
    return [tuple(r) for r in rows.values()]
