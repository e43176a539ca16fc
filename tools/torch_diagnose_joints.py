"""Diagnose joint under-detection on a held-out creature: instrument every
stage of the eval_rigging.py joint-extraction chain (attn filter ->
bandwidth -> mean-shift -> NMS -> flip) with the port's trained campaign
checkpoints — counterpart of tools/diagnose_joints.py.

  python tools/torch_diagnose_joints.py --dir campaign_out [--seed 200] [--device cuda]

Reads <dir>/joints/model_best.pt and <dir>/mask/model_best.pt (the layout
tools/torch_campaign.py writes); the creature's input flow is its GT flow
plus the dataset's seeded noise.  The networks, the bandwidth and the
mean-shift run on `--device` (default cuda; a CUDA device that is not there
is an error), the NMS and flip on the host.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default="campaign_out")
    ap.add_argument("--seed", type=int, default=200)
    ap.add_argument("--target-verts", type=int, default=1900)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, the card; 'cpu' runs the kernels' "
                         "plain versions)")
    return ap


@torch.no_grad()
def main(argv=None):
    from morig_tpu_torch.cli import _device
    from morig_tpu_torch.data.creature import creature_rig_dataset
    from morig_tpu_torch.geometry.clustering import (estimate_bandwidth, flip_joints,
                                                     meanshift_cluster, nms_modes)
    from morig_tpu_torch.train import checkpoint as ckpt
    from morig_tpu_torch.train.stages import RigStage

    args = build_parser().parse_args(argv)
    dev = _device(args)
    ds = creature_rig_dataset(num_models=1, seed=args.seed, num_points=args.points,
                              target_verts=args.target_verts, device=dev)
    gt = ds.models[0].rig
    dj = np.linalg.norm(gt.pos[:, None] - gt.pos[None], axis=-1)
    np.fill_diagonal(dj, np.inf)
    nn_d = dj.min(1)
    print(f"GT joints: {gt.num_joints}; nearest-joint dist: "
          f"min={nn_d.min():.4f} med={np.median(nn_d):.4f} max={nn_d.max():.4f}")

    b = ds.batch([0], device=dev)
    joint = RigStage(arch="jointnet", num_embed_sample=min(512, ds.pad_verts))
    mask = RigStage(arch="masknet", num_embed_sample=min(512, ds.pad_verts))
    jst, _ = ckpt.load_checkpoint(joint.init_state(0, device=dev),
                                  os.path.join(args.dir, "joints", "model_best.pt"))
    mst, _ = ckpt.load_checkpoint(mask.init_state(0, device=dev),
                                  os.path.join(args.dir, "mask", "model_best.pt"))

    disp = joint.infer(jst, b.pred_flow, b.mesh)[2]
    attn_logit = mask.infer(mst, b.pred_flow, b.mesh)[2]
    vm = b.mesh.vert_mask[0].cpu().numpy()
    verts = b.mesh.verts[0].cpu().numpy()[vm]
    shifted = verts + np.tanh(disp[0].float().cpu().numpy())[vm]
    attn = torch.sigmoid(attn_logit[0, :, 0].float()).cpu().numpy()[vm]

    # how close are shifted points to GT joints?
    d2j = np.linalg.norm(shifted[:, None] - gt.pos[None], axis=-1)
    near = d2j.min(1)
    print(f"shifted->GT-joint dist: med={np.median(near):.4f} "
          f"p90={np.percentile(near, 90):.4f}")
    # which GT joints attract any shifted point within 0.05?
    per_j = (d2j < 0.05).any(0)
    print(f"GT joints with a shifted point within 0.05: {per_j.sum()}/{len(per_j)}")

    a_n = (attn - attn.min()) / max(attn.max() - attn.min(), 1e-10)
    for thr in (0.1, 0.3, 0.5):
        print(f"attn_norm>{thr}: {(a_n > thr).sum()}/{len(a_n)} survivors")
    sel = a_n > 0.1
    pts = np.concatenate([shifted[sel], shifted[sel] * [-1, 1, 1]])  # reflect
    p = torch.as_tensor(pts, dtype=torch.float32, device=dev)[None]
    ones = torch.ones(p.shape[:2], dtype=torch.bool, device=dev)
    bw_t = estimate_bandwidth(p, ones)
    bw = float(bw_t[0])
    print(f"bandwidth(q=0.04) over {len(pts)} pts = {bw:.4f} "
          f"(vs med GT joint spacing {np.median(nn_d):.4f})")

    w = np.concatenate([a_n[sel], a_n[sel]])
    w_t = torch.as_tensor(w, dtype=torch.float32, device=dev)[None]

    def meanshift(bandwidth: float) -> np.ndarray:
        bws = torch.full_like(bw_t, bandwidth)
        return meanshift_cluster(p, bws, w_t, ones, num_iter=30)[0].cpu().numpy()

    moved = meanshift(bw)
    # rough unique-mode count pre-NMS at several merge radii
    for r in (bw, 0.5 * bw, 0.25 * bw):
        used = np.zeros(len(moved), bool)
        k = 0
        for i in range(len(moved)):
            if used[i]:
                continue
            used |= np.linalg.norm(moved - moved[i], axis=-1) < r
            k += 1
        print(f"pre-NMS distinct modes at radius {r:.4f}: {k}")

    counts = {}
    for dens in (0.05, 0.02, 0.01):
        modes, d = nms_modes(moved, w, bw, dens, 0.7, return_density=True)
        fm, _, _ = flip_joints(modes, extra=d)
        counts[("density", dens)] = (len(modes), len(fm))
        print(f"NMS thrd_density={dens}: {len(modes)} modes -> {len(fm)} after flip")
    # bandwidth sweep at the reference density
    for scale in (1.0, 0.7, 0.5, 0.35):
        bws = bw * scale
        moved2 = meanshift(bws)
        modes, d = nms_modes(moved2, w, bws, 0.02, 0.7, return_density=True)
        fm, _, _ = flip_joints(modes, extra=d)
        counts[("scale", scale)] = (len(modes), len(fm))
        print(f"bandwidth x{scale} ({bws:.4f}): {len(modes)} modes -> "
              f"{len(fm)} after flip")
    return counts


if __name__ == "__main__":
    main()
