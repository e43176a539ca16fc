"""How reproducible morig_tpu_torch's `capsule_predictor` is on one NVIDIA
GPU, and which of its trained networks moves the rig's joint count.

    PYTHONPATH=. python3 tools/torch_demo_repro.py [--steps 12]

Builds `capsule_predictor(train_steps=steps, seed=0)` on the card twice in
one process, then twice more under `torch.use_deterministic_algorithms`
(warn only; CUBLAS_WORKSPACE_CONFIG=:4096:8 is set for all four).  For each
pair: the largest parameter difference of each trained network (joint,
mask, bone, root) between the two builds, and the joint count of
`predict_rig` on each capsule (points of frames 1-5, as `predict-rig`
serves them), called twice on the first build.  Then each trained network
of the pair's second build put alone into the first: the joint counts
that gives, which names the networks whose difference moves the count.
Prints one JSON line per pair.

Every sum of the port's training steps is taken in a fixed order (K6's
db_table and the backward of the gathers through the ordered row scatter),
so both pairs show every parameter difference 0 and equal joint counts;
with an atomic scatter the builds parted and the counts moved between runs.
`chip_smoke.py` phase 16 checks the same bit for bit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

TRAINED = ("joint", "mask", "bone", "root")


def joint_counts(pred, pose_ds, rig_ds) -> list[int]:
    counts = []
    for i, model in enumerate(pose_ds.models):
        frames = np.stack([model.pts_traj[:, t, :] for t in range(1, 6)])
        counts.append(len(pred.predict_rig(rig_ds._mesh_cache[i], frames).pos))
    return counts


def max_diff(a: torch.nn.Module, b: torch.nn.Module) -> float:
    return max((pa - pb).abs().max().item() for pa, pb in zip(a.parameters(), b.parameters()))


def pair(steps: int, deterministic: bool) -> dict:
    from morig_tpu_torch.pipelines.rig_predict import capsule_predictor

    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    (pa, pose_ds, rig_ds), (pb, _, _) = (capsule_predictor(train_steps=steps) for _ in range(2))
    out = dict(deterministic=deterministic, steps=steps,
               max_param_diff={n: max_diff(getattr(pa, n), getattr(pb, n)) for n in TRAINED},
               joints_a=joint_counts(pa, pose_ds, rig_ds),
               joints_a_again=joint_counts(pa, pose_ds, rig_ds),
               joints_b=joint_counts(pb, pose_ds, rig_ds), joints_a_with_b_net={})
    for name in TRAINED:
        own = getattr(pa, name)
        setattr(pa, name, getattr(pb, name))
        out["joints_a_with_b_net"][name] = joint_counts(pa, pose_ds, rig_ds)
        setattr(pa, name, own)
    torch.use_deterministic_algorithms(False)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for deterministic in (False, True):
        print(json.dumps(pair(args.steps, deterministic)), flush=True)


if __name__ == "__main__":
    main()
