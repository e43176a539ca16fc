"""morig_tpu_torch/utils/profiling.py against morig_tpu/utils/profiling.py on
the CPU: StageTimer's sections, summary and report on one fake clock, and
trace() / annotate() over torch.profiler (a Chrome trace written where a
logdir is given, nothing otherwise)."""
from __future__ import annotations

import itertools
import json
import os

import pytest
import torch

from morig_tpu.utils import profiling as jprof
from morig_tpu_torch.utils import profiling as tprof


def _timed(module, monkeypatch, ticks):
    """A StageTimer of `module` driven by a fake perf_counter."""
    clock = iter(ticks)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
    timer = module.StageTimer()
    for name in ("nms", "mst", "nms", "preprocess", "nms"):
        with timer.section(name):
            pass
    with pytest.raises(ValueError), timer.section("mst"):
        raise ValueError("a section that raises is still timed")
    return timer


def test_stage_timer_matches_jax(monkeypatch):
    ticks = list(itertools.accumulate([0.0, 0.5, 1.0, 0.25, 2.0, 0.125, 0.5, 0.75, 1.5,
                                       0.0625, 3.0, 0.375, 0.25]))
    ref = _timed(jprof, monkeypatch, ticks)
    got = _timed(tprof, monkeypatch, ticks)
    assert got.summary() == ref.summary()
    assert got.report() == ref.report()
    assert got.counts == {"nms": 3, "mst": 2, "preprocess": 1}


def test_trace_writes_a_chrome_trace(tmp_path):
    """trace(logdir) writes logdir/trace.json holding the annotated range and
    the CPU ops inside it; trace(None) and annotate outside a trace run the
    block and write nothing."""
    x = torch.arange(64, dtype=torch.float32)
    with tprof.trace(str(tmp_path / "trace")):
        with tprof.annotate("scanned chunk"):
            y = (x * 2).sum()
    assert float(y) == 4032.0
    path = tmp_path / "trace" / "trace.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "scanned chunk" in names and any("mul" in str(n) for n in names)
    with tprof.trace(None), tprof.annotate("outside"):
        z = x + 1
    assert float(z[0]) == 1.0
    assert os.listdir(tmp_path) == ["trace"]
