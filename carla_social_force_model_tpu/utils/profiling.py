"""Lightweight runtime observability.

The reference has a single commented-out elapsed-time print
(run_simulation.py:219); here every rollout can report steps/sec and
agent-steps/sec, phases can be timed host-side, and JAX profiler traces can
be captured around any callable for xprof inspection.
"""
from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field

import jax

log = logging.getLogger(__name__)


@dataclass
class PhaseTimer:
    """Accumulating host-side phase timers."""

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [f"{name}: {total:.4f}s over {self.counts[name]} calls"
                 for name, total in sorted(self.totals.items())]
        return "\n".join(lines)


def measure_rollout(run_fn, state, *, num_steps: int, capacity: int,
                    repeats: int = 3, warmup: bool = True) -> dict:
    """Time a jitted rollout; returns steps/sec and agent-steps/sec."""
    if warmup:
        out = run_fn(state)
        jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = run_fn(state)
        jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
        best = min(best, time.perf_counter() - t0)
    return {
        "seconds": best,
        "steps_per_sec": num_steps / best,
        "agent_steps_per_sec": num_steps * capacity / best,
    }


@contextlib.contextmanager
def trace(log_dir: str = "sfm_trace"):
    """Capture a JAX profiler trace around a block (view with xprof or
    Perfetto).  The default directory is relative to the working
    directory."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
        log.info("profiler trace written to %s", log_dir)
