"""Tracking evaluation after a campaign of morig_tpu_torch, over all held-out
creatures at once — counterpart of tools/eval_campaign_tracking.py.

The reference tracks one mesh at a time over the test set
(eval_tracking.py:207-235); here the held-out branching creatures are
tracked together by one `BatchedTracker` (pipelines/tracking.py), which gives
each creature's full and visible flow errors (eval_tracking.py:230-235) and
the aggregate tracked frames/s on the device:

  python tools/torch_eval_campaign_tracking.py --dir campaign_out \\
      [--frames 11] [--points 512] [--timing-iters 3] [--device cuda]

Reads the campaign's sequential DeformNet (<dir>/deform_seq/model_best.pt,
else the discrete <dir>/deform/model_best.pt).  Writes
<dir>/results/tracking_batched.json (its per_model, mean and batched entries
as tools/eval_campaign_tracking.py writes them, plus `device`: the card's
name and power limit) and creature<seed>_tracking.npz per creature.  The
timed runs are whole calls of the tracker (uploads and the final read back
included) after a first one; the rate is from the fastest.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PAD = 2048


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default="campaign_out")
    ap.add_argument("--frames", type=int, default=11)
    ap.add_argument("--points", type=int, default=512)
    ap.add_argument("--target-verts", type=int, default=1900)
    ap.add_argument("--timing-iters", type=int, default=3)
    ap.add_argument("--seeds", default="200,201,202,203,204")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, the card; 'cpu' runs the kernels' "
                         "plain versions)")
    return ap


def main(argv=None) -> dict:
    from morig_tpu_torch.cli import _device
    from morig_tpu_torch.core import batch as B
    from morig_tpu_torch.data.creature import make_creature_sequence
    from morig_tpu_torch.eval.metrics import flow_errors
    from morig_tpu_torch.geometry import skeleton as sk
    from morig_tpu_torch.pipelines.tracking import BatchedTracker
    from morig_tpu_torch.train import checkpoint as ckpt
    from morig_tpu_torch.train.stages import DeformPoseStage
    from morig_tpu_torch.utils.profiling import device_info

    args = build_parser().parse_args(argv)
    dev = _device(args)
    seeds = [int(s) for s in args.seeds.split(",")]

    # the sequential model drives tracking (eval_tracking.py:21 loads the seq
    # checkpoint); the discrete one where there is none
    stage = DeformPoseStage()
    state = stage.init_state(0, device=dev)
    best = os.path.join(args.dir, "deform_seq", "model_best.pt")
    if not os.path.exists(best):
        best = os.path.join(args.dir, "deform", "model_best.pt")
    state, meta = ckpt.load_checkpoint(state, best)
    print(f"[track-eval] deform checkpoint: {best} (epoch {meta.get('epoch')})")

    # held-out creatures: GT rigs and animated partial point-cloud sequences
    rigs, entries, seqs = [], [], []
    for s in seeds:
        seq = make_creature_sequence(seed=s, num_frames=args.frames, num_points=args.points,
                                     target_verts=args.target_verts)
        c = seq["rig"]
        rigs.append(sk.Rig(names=list(c.names), pos=c.joints.astype(np.float64),
                           parents=c.parents, skins=c.skins))
        entries.append(B.build_mesh(c.verts, seq["tpl_edges"], seq["geo_edges"], PAD))
        seqs.append(seq)
        print(f"[track-eval] creature{s}: V={len(c.verts)} J={c.joints.shape[0]}")

    run = BatchedTracker(state.model, rigs, entries, max_joints=32).make_scanned()
    Bn = len(seeds)
    vtx0 = np.stack([B.pad_to(seqs[i]["rig"].verts, PAD) for i in range(Bn)])
    pts_b = np.stack([s["pts_traj"] for s in seqs])

    t0 = time.time()
    traj, vis, quats = run(vtx0, pts_b)
    first_s = time.time() - t0
    times = []
    for _ in range(args.timing_iters):
        t0 = time.time()
        run(vtx0, pts_b)
        times.append(time.time() - t0)
    dt = min(times) if times else first_s
    frames = Bn * (args.frames - 1)
    fps = frames / dt

    res_dir = os.path.join(args.dir, "results")
    os.makedirs(res_dir, exist_ok=True)
    per_model = []
    for i, s in enumerate(seeds):
        nv = len(seqs[i]["rig"].verts)
        terr = flow_errors(traj[i, :nv], seqs[i]["vtx_traj"][:, 1:, :], seqs[i]["vismask"][:, 1:])
        np.savez(os.path.join(res_dir, f"creature{s}_tracking.npz"), pred_vtx_traj=traj[i, :nv],
                 pred_vismask=vis[i, :nv], pred_quats=quats[i])
        per_model.append(dict(seed=s, **{k: float(v) for k, v in terr.items()}))
        print(f"[track-eval] creature{s}: {terr}")

    summary = dict(
        per_model=per_model,
        mean=dict(full_flow_error=float(np.mean([m["full_flow_error"] for m in per_model])),
                  vis_flow_error=float(np.mean([m.get("vis_flow_error", np.nan)
                                                for m in per_model]))),
        batched=dict(num_meshes=Bn, frames_per_mesh=args.frames - 1,
                     aggregate_frames_per_sec=fps, steady_seconds=dt, first_call_seconds=first_s,
                     timed_seconds=times, points=args.points, pad_verts=PAD),
        device=device_info(dev),
    )
    with open(os.path.join(res_dir, "tracking_batched.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("[track-eval] SUMMARY:", json.dumps(summary["mean"]),
          f"aggregate {fps:.3f} tracked frames/s ({Bn} meshes batched)")
    return summary


if __name__ == "__main__":
    main()
