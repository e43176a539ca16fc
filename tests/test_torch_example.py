"""The port's golden-path example (examples/torch_capsule_end_to_end.py) and
its joint diagnosis (tools/torch_diagnose_joints.py) on the CPU:

  * the example at a shrunk fixture (its module constants) and --steps 2,
    run twice: finite metrics, equal metrics and equal rig files (every
    stage's weights and draws come from fixed seeds), capsule_rig.txt
    written, and the JAX example's printed sections;
  * the diagnosis on a small campaign directory whose joints and mask
    checkpoints carry the same weights as the JAX tool's (JAX
    `save_checkpoint` -> the port's `load_flax_checkpoint` -> `.pt`): its
    networks' outputs at NETWORK, and on the JAX tool's network outputs
    every printed line, the joint counts (NMS by density, the bandwidth
    scale sweep) included, equal to the JAX tool's.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from morig_tpu.data import creature as jcreature

import torch_port_fixtures as F

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ex = _load("examples/torch_capsule_end_to_end.py", "torch_capsule_end_to_end")
SHRUNK = dict(NUM_POINTS=64, N_LAT=7, N_LON=6, NUM_EMBED_SAMPLE=32, VOX_DIMS=24,
              TRACK_FRAMES=2)


def test_example_repeats_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Two runs at the shrunk fixture and --steps 2: the same joint metrics,
    tracking errors and joint counts, the same capsule_rig.txt bytes, all
    finite; the sections of the JAX example's report."""
    for k, v in SHRUNK.items():
        monkeypatch.setattr(ex, k, v)
    runs, rigs = [], []
    for i in range(2):
        out = tmp_path / f"run{i}"
        runs.append(ex.main(["--steps", "2", "--device", "cpu", "--out", str(out)]))
        with open(out / "capsule_rig.txt", "rb") as f:
            rigs.append(f.read())
    text = capsys.readouterr().out
    a, b = runs
    assert rigs[0] == rigs[1] and rigs[0]
    assert a["rig_path"] == str(tmp_path / "run0" / "capsule_rig.txt")
    for k in ("num_joints", "num_gt_joints", "joints", "tracking"):
        assert a[k] == b[k], k
    assert a["num_joints"] >= 1 and a["num_gt_joints"] == 3
    assert all(np.isfinite(list(a["joints"].values()))), a["joints"]
    assert all(0.0 <= a["joints"][k] <= 1.0
               for k in ("joint_IoU", "joint_precision", "joint_recall"))
    assert np.isfinite(list(a["tracking"].values())).all() and a["frames_per_s"] > 0
    assert set(a["timings"]) == {"train_corr", "train_all_stages", "predict_rig", "tracking"}
    for section in ("== rig prediction ==", "== tracking ==", "== stage timings =="):
        assert text.count(section) == 2, section
    assert text.count("corr step 0:") == 2 and text.count("step 0: deform=") == 2


# ---------------------------------------------------------------------------
# the joint diagnosis against the JAX tool
# ---------------------------------------------------------------------------

DIAG = dict(seed=200, target_verts=200, points=128)      # ~190 vertices, the 256 bucket
COUNT_LINE = re.compile(r"^(NMS thrd_density=[\d.]+|bandwidth x[\d.]+)\D.*?(\d+) modes -> "
                        r"(\d+) after flip$")


def _counts(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        m = COUNT_LINE.match(line)
        if m:
            out[m.group(1)] = (int(m.group(2)), int(m.group(3)))
    return out


@pytest.fixture
def jax_cache_dir(tmp_path, monkeypatch):
    """JAX's persistent compile cache pointed into tmp_path while the JAX
    tool runs (its import calls `setup_compile_cache`), then put back."""
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_diagnose_counts_match_jax(tmp_path, monkeypatch, jax_cache_dir):
    """tools/torch_diagnose_joints.py and tools/diagnose_joints.py on one
    creature (seed 200, 200 target vertices, 128 points) from the same
    jointnet/masknet weights.  The port's JointNet shifts and MaskNet
    attention are held at NETWORK against the JAX tool's (the JAX side through its Pallas
    kernels); the chain after them runs on the JAX outputs, where every
    printed line must equal the JAX tool's: the joint counts (modes before
    and after the flip at each NMS density and each bandwidth scale), the
    survivors, the bandwidths and the pre-NMS modes.  On its own outputs the
    port's mean-shift modes move with their bf16-level differences (measured
    at these weights: 31 against 32 after the flip at bandwidth x0.7, 36
    against 35 at x0.5), so the counts are compared on the same inputs."""
    from morig_tpu.train import stages as jstages
    from morig_tpu_torch.train import stages as tstages

    root = str(tmp_path / "camp")
    ds = jcreature.creature_rig_dataset(num_models=1, seed=DIAG["seed"],
                                        num_points=DIAG["points"],
                                        target_verts=DIAG["target_verts"])
    F.carried_rig_checkpoints(root, ds.batch([0]))
    argv = ["--dir", root, "--seed", str(DIAG["seed"]), "--target-verts",
            str(DIAG["target_verts"]), "--points", str(DIAG["points"])]

    recorded = []
    jinfer = jstages.RigStage.infer

    def recording(self, *args):
        out = jinfer(self, *args)
        recorded.append(np.asarray(out[2]))
        return out

    monkeypatch.setattr(jstages.RigStage, "infer", recording)
    jtool = _load("tools/diagnose_joints.py", "diagnose_joints")
    monkeypatch.setattr(sys, "argv", ["diagnose_joints.py"] + argv)
    jout = io.StringIO()
    with F.jax_fused_kernels(), contextlib.redirect_stdout(jout):
        jtool.main()
    ref = _counts(jout.getvalue())

    queue = iter(recorded)
    tinfer = tstages.RigStage.infer

    def replaying(self, state, flow, mesh):
        own = tinfer(self, state, flow, mesh)[2]
        jax_out = torch.tensor(next(queue))
        if self.arch == "jointnet":           # the shift, as the tool uses it
            F.assert_rel_close(own, jax_out, F.NETWORK, what="jointnet")
        else:                                 # the attention (logits of either sign)
            F.assert_rel_close(torch.sigmoid(own), torch.sigmoid(jax_out), F.NETWORK,
                               what="masknet")
        return None, None, jax_out

    monkeypatch.setattr(tstages.RigStage, "infer", replaying)
    tool = _load("tools/torch_diagnose_joints.py", "torch_diagnose_joints")
    tout = io.StringIO()
    with contextlib.redirect_stdout(tout):
        got = tool.main(argv + ["--device", "cpu"])
    assert next(queue, None) is None and len(recorded) == 2
    assert tout.getvalue().splitlines() == jout.getvalue().splitlines()
    assert len(ref) == 7 and all(after >= 1 for _, after in ref.values()), ref
    assert {(f"NMS thrd_density={v}" if kind == "density" else f"bandwidth x{v}"): c
            for (kind, v), c in got.items()} == ref
