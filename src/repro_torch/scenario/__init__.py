"""Scenario engine of the port (counterpart of ``repro/scenario``):
declarative multi-phase traffic episodes driving the full adapt loop
(monitor detection → grid rescale / failure recovery / repricing →
reconfigure) over the simulator plane, whose every dispatch is one launch
of the FCFS kernel on the card.  Tier-scoped events (preemption storms,
tier outages, price spikes) drive the hybrid capacity-tier surface on planes
built with ``tiered_simulator_plane``.  ``LivePlane`` is not ported yet and
refuses with its ROADMAP item."""

from .engine import ScenarioEngine
from .planes import (LivePlane, SimulatorPlane, paper_simulator_plane,
                     tiered_simulator_plane)
from .registry import EPISODES, build_episode
from .report import (ControlAction, EpisodeReport, EventOutcome, PhaseReport,
                     WindowStat)
from .spec import (BATCH_DISTS, EVENT_KIND_SPECS, EVENT_KINDS, EventKind,
                   EventSpec, PhaseSpec, ScenarioSpec, Timeline, fuzz_kinds)
from .trace import TraceRecorder

__all__ = [
    "ScenarioSpec", "PhaseSpec", "EventSpec", "Timeline",
    "EventKind", "EVENT_KIND_SPECS", "EVENT_KINDS", "BATCH_DISTS",
    "fuzz_kinds",
    "ScenarioEngine",
    "SimulatorPlane", "LivePlane", "paper_simulator_plane",
    "tiered_simulator_plane",
    "EpisodeReport", "PhaseReport", "WindowStat", "EventOutcome",
    "ControlAction",
    "EPISODES", "build_episode",
    "TraceRecorder",
]
