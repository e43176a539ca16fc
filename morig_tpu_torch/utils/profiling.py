"""Tracing and per-stage timing — counterpart of morig_tpu/utils/profiling.py.

Two layers:
  * StageTimer — lightweight named wall-clock sections with streaming stats,
    for the host-side pipeline orchestration (preprocessing, NMS, MST).
  * trace() — context manager around torch.profiler for a Chrome trace of
    the host and the device (viewable in Perfetto or chrome://tracing), and
    annotate() — a named range inside it.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class StageTimer:
    """Named section timing with counts/totals; print or export as a dict."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: dict(total_s=self.totals[k], count=self.counts[k],
                    mean_ms=1000.0 * self.totals[k] / max(self.counts[k], 1))
            for k in self.totals
        }

    def report(self) -> str:
        rows = sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"])
        return "\n".join(
            f"{k:<30s} {v['count']:>6d}x  {v['mean_ms']:>9.2f} ms  "
            f"{v['total_s']:>8.2f} s total"
            for k, v in rows
        )


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[None]:
    """A torch.profiler trace of the block (the host, and the card where
    there is one) written to `logdir/trace.json` when a logdir is given;
    no-op otherwise."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range inside a trace (torch.profiler.record_function)."""
    import torch

    with torch.profiler.record_function(name):
        yield
