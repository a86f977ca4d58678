"""Tracing / profiling helpers — the JAX replacement for the
reference's `tic/toc` wall-clock instrumentation and `story` iterate
snapshots (SURVEY.md section 5: `hem_h3m_c_step.m:33,508`,
`vbhem_h3m_cluster.m:377-385`, `exprmt1_demo.m:42-54`).

  * :class:`PhaseTimer` — named wall-clock phases with block-until-ready
    so device work is attributed to the right phase.
  * :func:`device_trace` — context manager around `jax.profiler` for a
    TensorBoard-compatible device trace (XLA op-level timeline).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import jax


class PhaseTimer:
    """Accumulating named phase timer.

    >>> pt = PhaseTimer()
    >>> with pt.phase("e_step"):
    ...     out = e_step(...)           # doctest: +SKIP
    >>> pt.summary()                    # doctest: +SKIP
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = []
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:24s} {t:9.3f}s  x{self.counts[name]:<5d}"
                         f" {100.0 * t / total:5.1f}%")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str, create_perfetto_link: bool = False):
    """Device-level profiler trace (view with TensorBoard's profile
    plugin).  A trace that cannot start or stop raises."""
    jax.profiler.start_trace(logdir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
