"""The prover's observability: one span recorder for the process, and the
debug switches that print from it.

- `record()` makes a `Recorder` active for the process and yields it;
  `Recorder.drain()` returns and clears what it holds.  One recorder at a
  time, fed from the thread that proves.
- `span(name, **attrs)`: a context manager that records ``name``, its
  attributes, ``time.monotonic_ns()`` at start and end, its parent span
  and the id of its root span (``prove`` for a proof, ``vm`` and
  ``adapter`` for its input).  The clock is the one `benchmark/trace.py`
  puts the device trace on, so spans lie on the device's timeline as they
  are.  With no recorder active it returns one shared no-op object: one
  global read and one branch; nothing is stored and nothing syncs.
- `count(name, n=1)`: adds to a counter of the active recorder (nothing
  without one).
- `pull(tensor)` and `push(array, device)`: every transfer of the
  proof's path that waits for the device's queue goes through these two:
  each counts one of ``pulls`` and records a ``pull`` span; `pull`
  returns the tensor's NumPy array, `push` the array on the device.
- `phase(name, **attrs)`: a span that times itself even with no recorder
  active: the prover's phases, from which `prove.prove_cairo_m` fills its
  ``timing``, and the stwo framing's host trees.  A proof run with no
  recorder active keeps these few spans in a recorder of its own
  (`proving`), and drops them when it ends.

The debug switches, read when a proof starts (not at import), so that a
caller or a test can set them for one proof; with either set and no
recorder active, the proof records all its spans in a recorder of its own.
Neither changes a byte of the proof:

- ``CM_DEBUG_PHASES``: one line a prover phase and a step of the
  polynomial commitment, printed as its span closes: ``[prove +S.SSs]
  label`` (seconds since the prove began) for a span with a ``label``
  attribute, ``  [pcs +S.SSs] label`` (seconds since the previous step)
  for one inside the ``pcs`` phase.  Wall seconds with no device sync: a
  step that only queues device work reads short and the next step pays.
- ``CM_DEBUG_MICRO``: the spans with a ``micro`` attribute (each commit's
  LDE and Merkle tree: leaves, pyramid, the pull and host mirror of the
  tops; the stwo host tree; FRI's first fold and each layer) sync the
  device (``torch.cuda.synchronize`` on a card; the CPU needs none) when
  they open and before they close, and print ``    [tag +S.SSSs] label``.
  The syncs serialise the pipeline, so the totals under this switch exceed
  the prover's wall time: use it to attribute time, not to measure it.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch

_active = None  # the Recorder that `span` and `count` feed, if any
_phases = None  # the Recorder that `phase` feeds: the active one, or a proof's own


def phases_on() -> bool:
    return bool(os.environ.get("CM_DEBUG_PHASES"))


def micro_on() -> bool:
    return bool(os.environ.get("CM_DEBUG_MICRO"))


def sync(device):
    """Wait for the work queued on ``device`` (a card); the CPU runs
    eagerly and needs no wait."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _sync_current():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Span:
    """One timed interval: ``name``, ``attrs``, ``start``/``end``
    (``time.monotonic_ns``), ``id``, ``parent`` (the id of the span open
    around it, or None) and ``root`` (the id of the outermost one)."""

    __slots__ = ("rec", "name", "attrs", "start", "end", "id", "parent", "root")

    def __init__(self, rec, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.start = self.end = self.id = self.parent = self.root = None

    def __enter__(self):
        rec = self.rec
        if rec is not None:
            rec._open(self)
        self.start = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None and rec.micro and "micro" in self.attrs:
            _sync_current()
        self.end = time.monotonic_ns()
        if rec is not None:
            rec._close(self)
        return False

    def set(self, **attrs):
        """Add attributes known only once the span's work is done."""
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def __repr__(self):
        return (f"Span({self.name!r}, {self.attrs}, id={self.id}, "
                f"parent={self.parent}, root={self.root})")


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NO_SPAN = _NoSpan()


class Recorder:
    """Closed spans, in the order they closed, and counters, in memory
    until `drain`.  ``exporters`` are called with each span as it closes;
    ``micro`` makes the spans with a ``micro`` attribute sync."""

    def __init__(self):
        self.spans = []
        self.counts = {}
        self.exporters = []
        self.micro = False
        self._stack = []
        self._ids = itertools.count(1)

    def _open(self, sp: Span):
        stack = self._stack
        sp.id = next(self._ids)
        sp.parent = stack[-1].id if stack else None
        sp.root = stack[0].id if stack else sp.id
        stack.append(sp)
        if self.micro and "micro" in sp.attrs:
            _sync_current()

    def _close(self, sp: Span):
        stack = self._stack
        if stack and stack[-1] is sp:
            stack.pop()
        else:
            stack.remove(sp)
        sp.rec = None
        self.spans.append(sp)
        for export in self.exporters:
            export(self, sp)

    def drain(self):
        """-> (spans, counts) recorded since the last drain; clears both."""
        spans, counts = self.spans, self.counts
        self.spans, self.counts = [], {}
        return spans, counts


@contextlib.contextmanager
def record():
    """Make a new `Recorder` active for the process; yields it."""
    global _active, _phases
    if _active is not None:
        raise RuntimeError("a recorder is already active")
    rec = Recorder()
    _active = _phases = rec
    try:
        yield rec
    finally:
        _active = _phases = None


def span(name: str, **attrs):
    """A span of the active recorder; the shared no-op without one."""
    rec = _active
    if rec is None:
        return _NO_SPAN
    return Span(rec, name, attrs)


def phase(name: str, **attrs) -> Span:
    """A span that times itself with no recorder active too (see the
    module docstring); stored in the recorder that `proving` set, if any."""
    return Span(_phases, name, attrs)


def count(name: str, n: int = 1):
    rec = _active
    if rec is None:
        return
    rec.counts[name] = rec.counts.get(name, 0) + n


def pull(tensor):
    """``tensor.cpu().numpy()``, counted as one of ``pulls`` and recorded
    as a ``pull`` span (``to="host"``).  On a card the copy waits for every
    operation queued before it."""
    with _transfer("host"):
        return tensor.cpu().numpy()


def push(array, device):
    """``torch.from_numpy(array).to(device)``.  On a card this is a copy
    from pageable memory, which waits for every operation queued before
    it as a pull does: counted as one of ``pulls`` and recorded as a
    ``pull`` span (``to="device"``)."""
    with _transfer("device"):
        return torch.from_numpy(array).to(device)


def _transfer(to: str):
    if _active is None:
        return _NO_SPAN
    count("pulls")
    return span("pull", to=to)


@contextlib.contextmanager
def proving():
    """The recorder of one proof, with the debug switches' printers on it
    while the proof runs: the active recorder; else, with a switch set, a
    new one made active for the proof; else a new one that only `phase`
    feeds."""
    global _phases
    printers = []
    if phases_on():
        printers.append(_PhasePrinter())
    if micro_on():
        printers.append(_micro_line)
    with contextlib.ExitStack() as stack:
        rec = _active
        if rec is None and printers:
            rec = stack.enter_context(record())
        elif rec is None:
            rec = _phases = Recorder()
            stack.callback(_clear_phases)
        micro = rec.micro
        rec.micro = micro or micro_on()
        rec.exporters += printers
        try:
            yield rec
        finally:
            rec.micro = micro
            for p in printers:
                rec.exporters.remove(p)


def _clear_phases():
    global _phases
    _phases = None


class _PhasePrinter:
    """``CM_DEBUG_PHASES``'s lines, from the spans with a ``label``.  A
    label may name child spans, whose seconds it shows summed
    (``{upload:.2f}``)."""

    def __init__(self):
        self.mark = None  # end of the previous pcs step

    def __call__(self, rec, sp):
        label = sp.attrs.get("label")
        if label is None:
            return
        if "{" in label:
            sums: dict = {}
            for c in rec.spans:
                if c.parent == sp.id:
                    sums[c.name] = sums.get(c.name, 0.0) + c.seconds
            label = label.format_map(_Zero(sums))
        opened = rec._stack
        pcs = next((s for s in opened if s.name == "pcs"), None)
        if pcs is not None:
            since = self.mark if self.mark is not None else pcs.start
            self.mark = sp.end
            print(f"  [pcs +{(sp.end - since) / 1e9:6.2f}s] {label}", flush=True)
            return
        prove = next((s for s in opened if s.name == "prove"), None)
        t0 = prove.start if prove is not None else sp.start
        print(f"[prove +{(sp.end - t0) / 1e9:7.2f}s] {label}", flush=True)


class _Zero(dict):
    def __missing__(self, key):
        return 0.0


def _micro_line(rec, sp):
    """``CM_DEBUG_MICRO``'s line of a span with a ``micro`` attribute
    ``(tag, label format over the span's attributes)``."""
    micro = sp.attrs.get("micro")
    if micro is None:
        return
    tag, fmt = micro
    print(f"    [{tag} +{sp.seconds:6.3f}s] {fmt.format(**sp.attrs)}", flush=True)
