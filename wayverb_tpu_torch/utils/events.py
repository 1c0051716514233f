"""Progress events and phase timing.

Port of ``wayverb_tpu.utils.events``.

The reference wires an observer/event system through the engine
(``utilities/event.h``; 9-state enum in ``combined/engine.h:38-48``) for
GUI progress and live visualisation, but has no timers or kernel profiling.
Here: a minimal typed event hub, phase timing on the host clock, the
program's spans (``span``: the host seconds of each stage, and a
``wayverb.<name>`` range in a ``torch.profiler`` trace while one records),
a ``torch.profiler`` trace helper for device timelines, and the live field
view over the chunked runner.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Callable, Dict, List

import torch

# engine states, mirroring the reference enum
STATES = (
    "idle",
    "initialising",
    "starting_raytracer",
    "running_raytracer",
    "finishing_raytracer",
    "starting_waveguide",
    "running_waveguide",
    "finishing_waveguide",
    "postprocessing",
)


class EventHub:
    """connect/disconnect + fire, like the reference's event<Ts...>."""

    def __init__(self):
        self._listeners: Dict[str, List[Callable]] = {}

    def connect(self, name: str, fn: Callable) -> Callable:
        self._listeners.setdefault(name, []).append(fn)
        return fn

    def disconnect(self, name: str, fn: Callable) -> None:
        if name in self._listeners and fn in self._listeners[name]:
            self._listeners[name].remove(fn)

    def fire(self, name: str, *args) -> None:
        for fn in self._listeners.get(name, []):
            fn(*args)


@dataclasses.dataclass
class Elapsed:
    """The host seconds of one phase, filled when the phase ends."""

    seconds: float = 0.0


@dataclasses.dataclass
class PhaseTimer:
    """Host seconds and entries per phase; attach to an EventHub or use the
    context manager directly.

    The clock is the host's: a phase that enqueues device work and returns
    counts the enqueueing, not the device's time, and the timer never
    synchronises.  Device time comes from a profiler trace (``span``).
    Phases may end on several threads at once.
    """

    timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Times the block; yields an ``Elapsed`` whose ``seconds`` holds
        the block's host seconds once it ends."""
        took = Elapsed()
        t0 = time.perf_counter()
        try:
            yield took
        finally:
            took.seconds = time.perf_counter() - t0
            with self._lock:
                self.timings[name] = self.timings.get(name, 0.0) \
                    + took.seconds
                self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        with self._lock:
            rows = [(name, t, self.counts[name])
                    for name, t in self.timings.items()]
        return "\n".join(f"{name}: {t:.3f}s ({n}x)" for name, t, n in
                         sorted(rows, key=lambda row: -row[1]))


SPAN_PREFIX = "wayverb."
_SPANS = PhaseTimer()


@contextlib.contextmanager
def span(name: str):
    """One stage of the program, on the host clock and in a profiler trace.

    The block's host seconds and one entry are added to a process-wide
    ``PhaseTimer`` under ``name`` (``totals()``).  While a ``torch.profiler``
    records, the block is also a ``record_function`` range named
    ``wayverb.<name>``, on the trace's clock beside the device's activity,
    so that each idle gap of the device can be put down to the stage the
    host was in; with no profiler on, no range is entered.

    A span times the host and never synchronises: a stage that enqueues
    device work ends when the work is enqueued, and the device's time comes
    from the trace.  A span reads and creates no tensor.  Spans run on the
    thread that reaches them (a backward's on autograd's device thread) and
    nest by their intervals in the trace.
    """
    traced = (torch.profiler.record_function(SPAN_PREFIX + name)
              if torch.autograd._profiler_enabled()
              else contextlib.nullcontext())
    with _SPANS.phase(name) as took, traced:
        yield took


def totals() -> Dict[str, tuple]:
    """{span name: (host seconds, entries)} since the process started or
    ``reset_totals()``."""
    with _SPANS._lock:
        return {name: (t, _SPANS.counts[name])
                for name, t in _SPANS.timings.items()}


def reset_totals() -> None:
    """Forget every span's totals."""
    with _SPANS._lock:
        _SPANS.timings.clear()
        _SPANS.counts.clear()


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block and write it into
    ``log_dir`` as a Chrome trace (``trace.json``; view in Perfetto or
    chrome://tracing).  CPU activity always; CUDA activity too when a GPU
    is present.  Yields the profiler (``key_averages()`` and so on)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def iter_pressure_fields(mesh, source, receiver, num_steps: int,
                         every: int = 8):
    """Yield (step, pressure_field, outputs) snapshots during a run.

    The chunked runner surfaces the full field between chunks — the
    parity for the reference's live wavefront visualisation stream
    (``engine.h:110-117``).  Each yielded field and outputs are the chunk's
    own tensors, on the mesh's device: later chunks never write them.
    """
    from wayverb_tpu_torch.waveguide import checkpoint as ck

    state = ck.initial_state(mesh, receiver)
    done = 0
    while done < num_steps:
        n = min(every, num_steps - done)
        state, outputs = ck.run_chunk(mesh, source, receiver, state, n)
        done += n
        yield done, state.current, outputs
