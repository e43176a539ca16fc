"""End-to-end demo of morig_tpu_torch: train every stage on the synthetic
capsule, run the full rig-prediction pipeline and tracking, report metrics
— counterpart of examples/capsule_end_to_end.py.

The framework's "golden path": the six-stage workflow of the reference
(README.md:30-205) compressed onto the synthetic fixture:

    corr/deform -> joints+mask -> bone+root -> skin -> rig -> tracking

Run:  python examples/torch_capsule_end_to_end.py [--steps N] [--device cuda|cpu]

Each stage's weights are drawn from a fixed seed (STAGE_SEEDS) and every
training draw from a seeded torch.Generator, so two runs on one device give
the same metrics and the same rig file.  The fixture sizes and the tracking
frame count are the module constants below.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

NUM_POINTS, N_LAT, N_LON = 256, 13, 12      # the capsule fixture
NUM_EMBED_SAMPLE = 128
VOX_DIMS = 48
TRACK_FRAMES = 8                             # frame 0 is the rest pose
CORR_SEED, CORR_DRAWS, STAGE_DRAWS = 7, 2, 1
STAGE_SEEDS = dict(deform=11, joints=12, mask=13, skin=14, bone=15, root=16)
PRINT_EVERY = 25


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, the card; 'cpu' runs the kernels' "
                         "plain versions)")
    ap.add_argument("--out", default="results/capsule_demo")
    return ap


def main(argv=None) -> dict:
    from morig_tpu_torch.cli import _device
    from morig_tpu_torch.core.batch import build_mesh
    from morig_tpu_torch.data.pose import capsule_pose_dataset
    from morig_tpu_torch.data.rig import capsule_rig_dataset
    from morig_tpu_torch.data.skeleton_data import capsule_skel_dataset
    from morig_tpu_torch.data.synthetic import make_capsule_rig, make_capsule_sequence
    from morig_tpu_torch.eval.metrics import flow_errors, joint_match_metrics
    from morig_tpu_torch.geometry import skeleton as sk
    from morig_tpu_torch.geometry.voxel import voxelize_mesh
    from morig_tpu_torch.pipelines.rig_predict import RigPredictor
    from morig_tpu_torch.pipelines.tracking import Tracker
    from morig_tpu_torch.train.stages import (BoneStage, CorrPoseStage, DeformPoseStage,
                                              RigStage, RootStage, SkinStage)
    from morig_tpu_torch.utils.profiling import StageTimer

    args = build_parser().parse_args(argv)
    dev = _device(args)
    os.makedirs(args.out, exist_ok=True)
    timer = StageTimer()
    kw = dict(num_points=NUM_POINTS, n_lat=N_LAT, n_lon=N_LON)
    pose_ds = capsule_pose_dataset(num_models=2, num_frames=6, **kw)
    rig_ds = capsule_rig_dataset(num_models=2, **kw)
    skel_s = capsule_skel_dataset(num_models=2, max_joints=8, device=dev, **kw)
    pose_b = pose_ds.batch([0, 1], 0, 2, device=dev)
    rig_b = rig_ds.batch([0, 1], device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # stage 1: correspondence pretraining, then hand the extractor to the
    # deform stage (the reference's corr ckpt -> --init_extractor flow,
    # train_deform_pose.py:149)
    corr = CorrPoseStage()
    corr_state = corr.init_state(CORR_SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(CORR_DRAWS)
    with timer.section("train_corr"):
        for step in range(max(args.steps // 2, 1)):
            cm = corr.train_step(corr_state, pose_b, gen)
            if step % PRINT_EVERY == 0:
                print(f"corr step {step}: loss={cm['total_loss']:.3f}")
        sync()

    stages = {
        "deform": (DeformPoseStage(), pose_b),
        "joints": (RigStage(arch="jointnet", num_embed_sample=NUM_EMBED_SAMPLE), rig_b),
        "mask": (RigStage(arch="masknet", num_embed_sample=NUM_EMBED_SAMPLE), rig_b),
        "skin": (SkinStage(num_embed_sample=NUM_EMBED_SAMPLE), rig_b),
        "bone": (BoneStage(), skel_s),
        "root": (RootStage(), skel_s),
    }
    states = {name: stage.init_state(STAGE_SEEDS[name], device=dev)
              for name, (stage, _) in stages.items()}
    states["deform"] = stages["deform"][0].init_extractor_from(states["deform"], corr_state)

    gen = torch.Generator(device=dev).manual_seed(STAGE_DRAWS)
    with timer.section("train_all_stages"):
        for step in range(args.steps):
            last = {}
            for name, (stage, batch) in stages.items():
                if name == "deform" and step >= args.steps // 2:
                    continue  # deform converges fast on the fixture
                last[name] = stage.train_step(states[name], batch, gen)["total_loss"]
            if step % PRINT_EVERY == 0:
                print(f"step {step}: " + " ".join(f"{n}={v:.3f}" for n, v in last.items()))
        sync()

    predictor = RigPredictor(*(states[name].model
                               for name in ("deform", "joints", "mask", "root", "bone", "skin")))

    cap = make_capsule_rig(N_LAT, N_LON)
    vox = voxelize_mesh(cap.verts, cap.faces, dims=VOX_DIMS)
    m0 = pose_ds.models[0]
    pts_frames = np.stack([m0.pts_traj[:, t, :] for t in range(1, 6)])
    with timer.section("predict_rig"):
        rig = predictor.predict_rig(rig_ds._mesh_cache[0], pts_frames, vox=vox)
    rig_path = os.path.join(args.out, "capsule_rig.txt")
    rig.save(rig_path)

    gt = rig_ds.models[0].rig
    jm = joint_match_metrics(rig.pos, gt.pos, feature_sizes=0.12)
    print("\n== rig prediction ==")
    print(f"pred joints: {rig.num_joints} (gt {gt.num_joints})")
    print({k: round(v, 4) for k, v in jm.items()})

    # tracking with the trained deform stage
    seq = make_capsule_sequence(num_frames=TRACK_FRAMES, max_bend=0.5, partial=False, seed=5,
                                **kw)
    track_rig = sk.Rig(names=list(cap.names), pos=cap.joints.astype(float),
                       parents=cap.parents, skins=cap.skins)
    entry = build_mesh(cap.verts, seq["tpl_edges"], seq["geo_edges"], rig_ds.pad_verts)
    tracker = Tracker(states["deform"].model, track_rig, entry)
    t0 = time.perf_counter()
    with timer.section("tracking"):
        traj, vis, quats = tracker.run(cap.verts, seq["pts_traj"])
    fps = traj.shape[1] / (time.perf_counter() - t0)
    errs = flow_errors(traj, seq["vtx_traj"][:, 1:, :], seq["vismask"][:, 1:])
    print("\n== tracking ==")
    print({k: round(v, 5) for k, v in errs.items()}, f"| {fps:.2f} tracked frames/sec")

    print("\n== stage timings ==")
    print(timer.report())
    return dict(num_joints=rig.num_joints, num_gt_joints=gt.num_joints, joints=jm,
                tracking=errs, frames_per_s=fps, rig_path=rig_path, timings=timer.summary())


if __name__ == "__main__":
    main()
