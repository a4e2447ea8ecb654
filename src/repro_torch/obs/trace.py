"""Gopher Scope: lightweight host-side span tracing.

The port of the JAX package's ``obs/trace.py``: the same spans, counters,
exports and schema check, with two calls made for torch (``sync`` and
``profile_ctx``, below).

The engine's BSP loop is a host loop over supersteps whose launches run
ahead of the host: nothing host-side can see where a run's time goes. A
:class:`Tracer` gives the host a nested-span clock:

    run → phase → superstep → {plan, pack, exchange, sweep, halt-vote}

with wall-clock durations, per-span attributes (dispatch counts, wire
slots, changed counts), and three export formats:

  * ``chrome_trace()`` — Chrome-trace / Perfetto JSON (``ph: "X"`` complete
    events; load in ``ui.perfetto.dev`` or ``chrome://tracing``);
  * ``jsonl()`` / ``write_jsonl()`` — one event per line for ad-hoc grep;
  * ``Span`` objects directly (``tracer.spans``) for the text timeline in
    ``launch/scope.py``.

Cost model — the part that must hold for the engine to thread a tracer
through its loops unconditionally:

  * DISABLED (``Tracer(enabled=False)`` or the module ``NOOP`` singleton):
    ``span()`` returns one shared no-op context manager; entering/exiting
    it is two attribute-free method calls and no allocation. The engine
    reads nothing more from the device and launches nothing more than an
    untraced run does.
  * ENABLED: each span costs one ``perf_counter_ns`` pair and one small
    object append. ``boundary_sync=True`` additionally calls
    ``torch.cuda.synchronize`` on a stage's device when its outputs are
    CUDA tensors, so per-stage wall-clock is honest (otherwise a span
    measures the enqueue and the halt-vote span — the host read of the
    vote — absorbs the device queue).

``profiler_dir`` arms the optional device-side capture: the run span
wraps itself in ``torch.profiler.profile`` (CPU activity, and CUDA when
the run is on the card), and a Chrome trace of the kernels lands in that
directory next to the host spans.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

import torch

__all__ = ["Span", "Tracer", "NOOP", "get_tracer", "set_tracer",
           "validate_chrome_trace"]


@dataclasses.dataclass
class Span:
    """One closed span. Times are ns from the tracer's epoch."""
    name: str
    t0_ns: int
    dur_ns: int
    depth: int
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_chrome(self) -> dict:
        return {"name": self.name, "ph": "X", "pid": 0, "tid": 0,
                "ts": self.t0_ns / 1e3, "dur": self.dur_ns / 1e3,
                "cat": "gopher", "args": self.args}


class _NoopSpan:
    """Shared no-op context manager: the disabled tracer's entire cost."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):                      # attribute writes vanish too
        return self


_NOOP_SPAN = _NoopSpan()


class _LiveSpan:
    __slots__ = ("tracer", "name", "t0_ns", "depth", "args")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0_ns = 0
        self.depth = 0

    def __enter__(self):
        t = self.tracer
        self.depth = len(t._stack)
        t._stack.append(self)
        self.t0_ns = time.perf_counter_ns() - t._epoch_ns
        return self

    def __exit__(self, *exc):
        now = time.perf_counter_ns() - self.tracer._epoch_ns
        top = self.tracer._stack.pop()
        assert top is self, f"span {self.name!r} closed out of order"
        self.tracer.spans.append(Span(name=self.name, t0_ns=self.t0_ns,
                                      dur_ns=now - self.t0_ns,
                                      depth=self.depth, args=self.args))
        return False

    def set(self, **kw):
        """Attach attributes mid-span (wire counts known only after the
        stage ran)."""
        self.args.update(kw)
        return self


class Tracer:
    """Nested-span tracer. ``enabled=False`` degenerates every call to the
    shared no-op span — the engine can hold a tracer unconditionally."""

    def __init__(self, enabled: bool = True, boundary_sync: bool = False,
                 profiler_dir: Optional[str] = None):
        self.enabled = enabled
        self.boundary_sync = boundary_sync
        self.profiler_dir = profiler_dir
        self.profiles: List[str] = []        # traces profile_ctx wrote
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        self._stack: List[_LiveSpan] = []
        self._epoch_ns = time.perf_counter_ns()

    # ---------------- recording ----------------
    def span(self, name: str, **args):
        if not self.enabled:
            return _NOOP_SPAN
        return _LiveSpan(self, name, args)

    def count(self, name: str, n: int = 1) -> None:
        """Dispatch counters (host-side calls of a run's stages)."""
        if self.enabled:
            self.counts[name] = self.counts.get(name, 0) + n

    def sync(self, x):
        """Boundary mode: wait for a stage's outputs so the enclosing span's
        wall-clock covers device execution, not just the enqueue —
        ``torch.cuda.synchronize`` on the device of the first CUDA tensor
        in ``x`` (a tensor, or a tuple, list or dict holding one). Identity
        when boundary_sync is off or nothing in ``x`` is on a card."""
        if self.enabled and self.boundary_sync and x is not None:
            dev = _cuda_device(x)
            if dev is not None:
                torch.cuda.synchronize(dev)
        return x

    def profile_ctx(self, device=None):
        """The optional device-side capture around a run span: a no-op
        context unless ``profiler_dir`` was armed. Armed, it runs the body
        under ``torch.profiler.profile`` — CPU activity, plus CUDA when
        ``device`` is a card — and on exit writes its Chrome trace into
        ``profiler_dir`` (one file per capture, appended to
        ``self.profiles``)."""
        if not (self.enabled and self.profiler_dir):
            return contextlib.nullcontext()
        return self._profile(device)

    @contextlib.contextmanager
    def _profile(self, device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device is not None and torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self.profiler_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield prof
        path = os.path.join(self.profiler_dir,
                            f"torch_profile_{len(self.profiles)}.json")
        prof.export_chrome_trace(path)
        self.profiles.append(path)

    # ---------------- invariants ----------------
    @property
    def balanced(self) -> bool:
        """True iff every opened span has been closed."""
        return not self._stack

    def open_spans(self) -> List[str]:
        return [s.name for s in self._stack]

    # ---------------- export ----------------
    def chrome_trace(self) -> dict:
        """Chrome-trace JSON object (Perfetto-loadable)."""
        return {
            "displayTimeUnit": "ms",
            "traceEvents": [s.to_chrome() for s in self.spans],
            "otherData": {"format": "gopher-scope-v1",
                          "counts": dict(self.counts)},
        }

    def write_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def jsonl(self) -> str:
        lines = [json.dumps({"name": s.name, "t0_us": s.t0_ns / 1e3,
                             "dur_us": s.dur_ns / 1e3, "depth": s.depth,
                             "args": s.args})
                 for s in self.spans]
        return "\n".join(lines)

    def write_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.jsonl() + ("\n" if self.spans else ""))
        return path

    def clear(self) -> None:
        assert self.balanced, f"clear with open spans: {self.open_spans()}"
        self.spans.clear()
        self.counts.clear()
        self._epoch_ns = time.perf_counter_ns()


def _cuda_device(x):
    """The device of the first CUDA tensor in ``x``, else None."""
    if isinstance(x, torch.Tensor):
        return x.device if x.is_cuda else None
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        for v in x:
            dev = _cuda_device(v)
            if dev is not None:
                return dev
    return None


#: the module no-op tracer — what the engine holds when no tracer is given.
NOOP = Tracer(enabled=False)

_default: Tracer = NOOP


def get_tracer() -> Tracer:
    """The process default tracer (NOOP unless set_tracer armed one)."""
    return _default


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install (or, with None, disarm) the process default tracer."""
    global _default
    _default = tracer if tracer is not None else NOOP
    return _default


# ---------------- schema validation (CI smoke) ----------------

def validate_chrome_trace(obj: dict) -> None:
    """Assert ``obj`` is a structurally valid gopher-scope Chrome trace:
    the envelope keys exist, every event is a complete ('X') event with
    numeric ts/dur, and span nesting is consistent (children lie inside
    their parents). Raises AssertionError with a pointed message."""
    assert isinstance(obj, dict), "trace must be a JSON object"
    assert "traceEvents" in obj, "missing traceEvents"
    evs = obj["traceEvents"]
    assert isinstance(evs, list) and evs, "traceEvents empty"
    for i, e in enumerate(evs):
        for k in ("name", "ph", "ts", "dur", "pid", "tid"):
            assert k in e, f"event {i} missing {k!r}"
        assert e["ph"] == "X", f"event {i}: ph {e['ph']!r} != 'X'"
        assert isinstance(e["ts"], (int, float)), f"event {i}: ts not numeric"
        assert isinstance(e["dur"], (int, float)) and e["dur"] >= 0, \
            f"event {i}: bad dur"
    # nesting: sort by start; a later-starting span either nests inside or
    # begins after every currently-open span (no partial overlap on a tid)
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in evs),
                   key=lambda s: (s[0], -s[1]))
    stack: list = []
    eps = 1e-3   # µs slack: ns->µs rounding in the exporter
    for t0, t1, name in spans:
        while stack and t0 >= stack[-1][1] - eps:
            stack.pop()
        assert not stack or t1 <= stack[-1][1] + eps, \
            f"span {name!r} [{t0},{t1}] overlaps parent " \
            f"{stack[-1][2]!r} [{stack[-1][0]},{stack[-1][1]}]"
        stack.append((t0, t1, name))
