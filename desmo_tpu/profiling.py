"""Profiling and sanitizing hooks (SURVEY §5.1-5.2).

The reference has no profiler, timers, or sanitizers — its only timing signal
is checkpoint filename timestamps. Here:

* ``trace(logdir)`` — context manager around ``jax.profiler`` emitting a
  TensorBoard-compatible device trace of the training chunk.
* ``StepTimer`` — throughput bookkeeping that waits for the device
  (``jax.block_until_ready``) before reading the clock.
* ``debug_nans(enable)`` — toggles JAX's NaN checker, the purity-preserving
  analog of the reference's determinism/sanitizer story (fixed seeds only).
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace: ``with profiling.trace('/tmp/trace'): step()``."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def debug_nans(enable: bool = True) -> None:
    jax.config.update("jax_debug_nans", enable)


class StepTimer:
    """Accumulates (steps, seconds) intervals; reports steps/sec."""

    def __init__(self):
        self.steps = 0
        self.seconds = 0.0
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, steps: int, sync_tree=None) -> None:
        if sync_tree is not None:
            jax.block_until_ready(sync_tree)
        self.seconds += time.perf_counter() - self._t0
        self.steps += steps

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.seconds if self.seconds > 0 else float("nan")
