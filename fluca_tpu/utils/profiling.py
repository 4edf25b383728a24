"""Profiling / tracing utilities.

Reference: PETSc log events MESH_SetUp, NS_SetUp, NS_Step,
NS_FormJacobian, NS_FormFunction + -log_view (fluca/src/ns/interface/
nspkg.c:21-34, SURVEY.md §5). JAX equivalent: named trace annotations
that show up in jax.profiler traces, plus host-side wall-clock event
accumulation printable as a -log_view-style table.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class EventLog:
    def __init__(self):
        self.times = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def event(self, name: str):
        """Host-side timed + device-trace-annotated scope."""
        t0 = time.perf_counter()
        with jax.profiler.TraceAnnotation(name):
            yield
        self.times[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def view(self) -> str:
        """-log_view-style summary table."""
        lines = [f"{'Event':24s} {'Count':>8s} {'Time (s)':>12s} "
                 f"{'Avg (ms)':>10s}"]
        for name in sorted(self.times):
            t, n = self.times[name], self.counts[name]
            lines.append(
                f"{name:24s} {n:8d} {t:12.4f} {1e3 * t / max(n, 1):10.2f}"
            )
        return "\n".join(lines)


global_log = EventLog()


def start_trace(logdir: str):
    """Start a jax.profiler trace (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(logdir)


def stop_trace():
    jax.profiler.stop_trace()
