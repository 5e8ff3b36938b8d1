"""The port's spans and counters.

- ``span(name)``: a context manager around one layer of a request or a
  step. While a ``torch.profiler`` session records, it opens
  ``record_function("dfvod.<name>")``, so that the range lies on the
  profiler's timeline with the kernels and copies it caused, and every
  idle gap of the card can be put down to the innermost span the host was
  in. Otherwise it returns one shared null context after a single flag
  test. Spans nest on the calling thread; the profiler's ``cpu_parent``
  gives each one's cause. The roots are ``serve.request`` and
  ``train.step``.
- ``count(name, n)``, ``counter(name)``, ``counters()``: the port's one
  store of cumulative integer counters (the hand-written kernels' launches
  among them, by kernel name).
- Device syncs: while a profiler records, a root span sets
  ``torch.cuda.set_sync_debug_mode("warn")`` and turns each sync warning
  into ``count("sync.<innermost span>")``; on exit it restores the mode
  it found (``"error"`` where a caller asks syncs to raise). Sync counters
  therefore grow only while a profiler records.

The profiler is the switch: ``--profile_dir`` of ``cli/main.py`` and
``cli/benchmark.py`` turns tracing on, and nothing else does.
"""
from __future__ import annotations

import contextlib
import threading
import warnings

import torch
from torch.autograd import profiler as _profiler

ROOTS = frozenset(("serve.request", "train.step"))
# the message of c10's ``warn_or_error_on_sync``
SYNC_WARNING = "called a synchronizing CUDA operation"

_NULL = contextlib.nullcontext()
_counters: dict = {}
# autograd's device threads count the backward's kernels beside the caller
_lock = threading.Lock()
_local = threading.local()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    """The counter ``name``'s total so far (0 before its first count)."""
    return _counters.get(name, 0)


def counters() -> dict:
    """A copy of every counter: {name: total}."""
    with _lock:
        return dict(_counters)


def span(name: str):
    """A context manager around the layer ``name`` (see the module's
    docstring): a ``record_function`` range ``dfvod.<name>`` while a
    profiler records, a shared null context otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "range", "syncs")

    def __init__(self, name):
        self.name = name
        self.range = torch.profiler.record_function("dfvod." + name)
        self.syncs = None

    def __enter__(self):
        stack = _stack()
        if self.name in ROOTS and not stack and torch.cuda.is_initialized():
            self.syncs = _SyncCounter()
            self.syncs.__enter__()
        stack.append(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        _stack().pop()
        if self.syncs is not None:
            self.syncs.__exit__(*exc)
        return False


class _SyncCounter:
    """The root span's sync debug mode "warn", its warnings counted under
    the innermost span, the previous mode and warning filters restored on
    exit."""

    def __enter__(self):
        self.mode = torch.cuda.get_sync_debug_mode()
        self.filters = warnings.catch_warnings()
        self.filters.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        self.show = warnings.showwarning
        warnings.showwarning = self._show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if str(message).startswith(SYNC_WARNING):
            stack = _stack()
            count("sync." + (stack[-1] if stack else "outside"))
        else:
            self.show(message, category, filename, lineno, file, line)

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self.mode)
        self.filters.__exit__(*exc)
        return False
