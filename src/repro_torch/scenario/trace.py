"""Chrome-trace-event export of the scenario control plane.

:class:`TraceRecorder` collects the episode's control-loop activity —
phases, monitoring windows, injected events, adaptation searches, deploys,
reroutes — as Chrome trace events (the ``traceEvents`` JSON format both
Perfetto and ``chrome://tracing`` open natively).  The scenario engine emits into a recorder handed
to it (``ScenarioEngine(..., trace=...)``), and ``TraceRecorder.dump`` writes
it out.

Timeline semantics: timestamps are **episode seconds** (the continuous
clock the planes thread across segments), converted to the format's
microseconds.  Durations are episode seconds too, with one deliberate
exception — adaptation-search spans overlay their *wall-clock* duration at
the episode instant the search fired, because re-optimization is
instantaneous in episode time (the paper charges it in BO evaluations, not
seconds) and a zero-width span would be invisible.  Search spans carry
``bo_evals`` and ``wall_ms`` in their ``args`` so both costs stay
readable.

Everything here is plain data (no torch, no numpy requirement beyond
casts the caller already did); events are appended in call order and
serialized verbatim.  Counterpart of ``repro/scenario/trace.py``, copied.
"""

from __future__ import annotations

import json

# Lane layout of the exported trace: one synthetic process, fixed thread
# rows so every episode renders identically.
TID_PHASES = 0
TID_WINDOWS = 1
TID_CONTROL = 2
TID_EVENTS = 3
_THREAD_NAMES = {
    TID_PHASES: "phases",
    TID_WINDOWS: "monitor windows",
    TID_CONTROL: "control plane",
    TID_EVENTS: "injected events",
}
_PID = 1


def _us(seconds: float) -> int:
    return int(round(float(seconds) * 1e6))


class TraceRecorder:
    """Collects Chrome trace events for one scenario episode."""

    def __init__(self, process_name: str = "scenario"):
        self.events: list[dict] = []
        for tid, name in _THREAD_NAMES.items():
            self.events.append({
                "ph": "M", "name": "thread_name", "pid": _PID, "tid": tid,
                "args": {"name": name}})
        self.events.append({
            "ph": "M", "name": "process_name", "pid": _PID, "tid": 0,
            "args": {"name": process_name}})

    # ------------------------------------------------------------ emitters
    def span(self, name: str, start_s: float, dur_s: float, *,
             tid: int = TID_CONTROL, cat: str = "scenario",
             args: dict | None = None) -> None:
        """A complete ("X") span: ``start_s``/``dur_s`` in episode
        seconds (durations clamp at 0 — Perfetto rejects negatives)."""
        self.events.append({
            "ph": "X", "name": name, "cat": cat, "pid": _PID, "tid": tid,
            "ts": _us(start_s), "dur": max(_us(dur_s), 0),
            "args": dict(args or {})})

    def instant(self, name: str, at_s: float, *, tid: int = TID_CONTROL,
                cat: str = "scenario", args: dict | None = None) -> None:
        """A thread-scoped instant ("i") marker."""
        self.events.append({
            "ph": "i", "name": name, "cat": cat, "pid": _PID, "tid": tid,
            "ts": _us(at_s), "s": "t", "args": dict(args or {})})

    def counter(self, name: str, at_s: float, values: dict,
                *, tid: int = TID_WINDOWS) -> None:
        """A counter ("C") sample: ``values`` maps series name -> number."""
        self.events.append({
            "ph": "C", "name": name, "pid": _PID, "tid": tid,
            "ts": _us(at_s),
            "args": {k: float(v) for k, v in values.items()}})

    # --------------------------------------------------------------- export
    @property
    def n_events(self) -> int:
        """Recorded events, metadata rows excluded."""
        return sum(1 for e in self.events if e["ph"] != "M")

    def to_dict(self) -> dict:
        """The Chrome trace JSON object Perfetto opens directly."""
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def dump(self, path: str) -> None:
        """Write the trace JSON to ``path`` (open in https://ui.perfetto.dev
        or chrome://tracing)."""
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh)
            fh.write("\n")
