"""Tracing and per-stage timing — counterpart of morig_tpu/utils/profiling.py.

Two layers:
  * StageTimer — lightweight named wall-clock sections with streaming stats,
    for the host-side pipeline orchestration (preprocessing, NMS, MST).
  * trace() — context manager around torch.profiler for a Chrome trace of
    the host and the device (viewable in Perfetto or chrome://tracing), and
    annotate() — a named range inside it.
Also `device_info`, the device's name and power limit that every measured
number carries, and the peak device memory of a phase (`reset_peak`,
`peak_gib`).
"""
from __future__ import annotations

import contextlib
import gc
import os
import subprocess
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


def device_info(dev) -> dict:
    """{"name", "power_limit"} of a device: for a card its name and the power
    limit nvidia-smi reports (None where it cannot be read), for the CPU
    "cpu" and None."""
    import torch

    dev = torch.device(dev)
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    power = None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              f"--id={index}"], capture_output=True, text=True, check=True,
                             timeout=60)
        power = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return {"name": torch.cuda.get_device_name(index), "power_limit": power}


def reset_peak(dev) -> None:
    """Free what the caching allocator holds unused (e.g. the pools of CUDA
    graphs that are gone) and restart the card's peak-memory count."""
    import torch

    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gib(dev) -> Optional[float]:
    """The card's peak allocated memory since `reset_peak`, GiB (None on the
    CPU)."""
    import torch

    if torch.device(dev).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30
