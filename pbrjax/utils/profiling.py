"""Per-stage timing: the headless counterpart of the reference's kernel-time
window (``InfoWindow`` polling per-kernel GPU times via OpenCL event
profiling, CL.cpp:480-488, InfoWindow.cpp:85-121).

``StageTimer`` records named spans (host wall-clock around blocked device
work) and renders a table; ``trace_to_file`` wraps ``jax.profiler`` for real
XLA traces viewable in TensorBoard/Perfetto; ``gpu_card`` names the card a
measurement ran on.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple


def gpu_card() -> str:
    """``name, power.limit`` of each GPU as nvidia-smi reports them (a card
    below its maximum power limit runs slower under load, so every number
    is kept beside it)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


class StageTimer:
    """Accumulates (count, total seconds) per named stage."""

    def __init__(self) -> None:
        self._acc: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])

    @contextlib.contextmanager
    def span(self, name: str, sync=None) -> Iterator[None]:
        """Time a block. Pass ``sync`` a jax array/pytree to block on it
        before stopping the clock (device work is async)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                import jax

                jax.block_until_ready(sync)
            rec = self._acc[name]
            rec[0] += 1
            rec[1] += time.perf_counter() - t0

    def add(self, name: str, seconds: float) -> None:
        rec = self._acc[name]
        rec[0] += 1
        rec[1] += seconds

    def rows(self) -> List[Tuple[str, int, float, float]]:
        """(name, count, total_ms, mean_ms), insertion order."""
        return [
            (name, int(c), tot * 1e3, (tot / c) * 1e3 if c else 0.0)
            for name, (c, tot) in self._acc.items()
        ]

    def table(self) -> str:
        """The InfoWindow table, as text."""
        rows = self.rows()
        if not rows:
            return "(no stages timed)"
        w = max(len(r[0]) for r in rows)
        lines = [f"{'stage':<{w}}  {'count':>6}  {'total ms':>10}  {'mean ms':>9}"]
        for name, c, tot, mean in rows:
            lines.append(f"{name:<{w}}  {c:>6}  {tot:>10.2f}  {mean:>9.3f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self._acc.clear()


@contextlib.contextmanager
def trace_to_file(logdir: str) -> Iterator[None]:
    """XLA-level profiler trace (open with TensorBoard / Perfetto)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
