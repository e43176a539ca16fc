"""Joint-extraction threshold sweep on the port's trained campaign
checkpoints — counterpart of tools/sweep_joint_params.py.

The clustering stage limits joint IoU on the campaign's creatures (the
reference defaults are bandwidth q=0.04, keep 0.1, density 0.02, NMS-attn
0.7 — eval_rigging.py:80-95, cluster_utils.py:39-63).  This tool tunes
those four thresholds on the campaign's VALIDATION creatures and reports the
chosen configuration on the held-out TEST creatures, reusing the trained
jointnet/masknet checkpoints (no retraining):

  python tools/torch_sweep_joint_params.py --dir campaign_out --dump   # infer once
  python tools/torch_sweep_joint_params.py --dir campaign_out          # sweep

The dump phase reads the layout tools/torch_campaign.py writes
(<dir>/joints/model_best.pt, <dir>/mask/model_best.pt, <dir>/pred_flows.npz
with keys val{i} and te{i}) and stores, per creature, the shifted points
(valid vertices only), the raw attention, the inside-voxel mask and the GT
joints in <dir>/joint_sweep_inputs.npz (the JAX tool's keys): everything
upstream of the swept thresholds.  The sweep phase runs the bandwidth and
the mean-shift on `--device`, one per (quantile, keep) pair, shared across
all (density, attn_nms) pairs, and the NMS and flip on the host; it writes
<dir>/joint_sweep_result.json with the JAX tool's keys, plus
`bandwidth_sample_rows: 0` in `best` (the sweep estimates the bandwidth
over all rows, and the campaign applies `best` over the pipeline's default
of 1024) and `device` (the card's name and power limit).  `--device`
defaults to cuda; a CUDA device that is not there is an error.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VAL_SEEDS = [100, 101, 102]
TEST_SEEDS = [200, 201, 202, 203, 204]
DEFAULT_KEY = (0.04, 0.1, 0.02, 0.7)    # the reference thresholds (q, keep, density, attn_nms)
MEANSHIFT_ITERS = 30


@torch.no_grad()
def dump(args, dev) -> dict:
    """Infer the shifted points and attention of the val and test creatures
    with the campaign's joints/mask checkpoints; write and return the
    arrays of joint_sweep_inputs.npz."""
    from morig_tpu_torch.data.creature import creature_rig_dataset, make_creature
    from morig_tpu_torch.geometry.voxel import inside_check_np, voxelize_mesh
    from morig_tpu_torch.train import checkpoint as ckpt
    from morig_tpu_torch.train.stages import RigStage

    with np.load(os.path.join(args.dir, "pred_flows.npz")) as z:
        flows = {key: [z[f"{key}{i}"] for i in range(len(seeds))]
                 for key, seeds in (("val", VAL_SEEDS), ("te", TEST_SEEDS))}
    out = {}
    for split, seeds in (("val", VAL_SEEDS), ("te", TEST_SEEDS)):
        ds = creature_rig_dataset(num_models=len(seeds), seed=seeds[0], num_points=args.points,
                                  target_verts=args.target_verts, pred_flows=flows[split],
                                  device=dev)
        joint = RigStage(arch="jointnet", num_embed_sample=min(512, ds.pad_verts))
        mask = RigStage(arch="masknet", num_embed_sample=min(512, ds.pad_verts))
        jst, _ = ckpt.load_checkpoint(joint.init_state(0, device=dev),
                                      os.path.join(args.dir, "joints", "model_best.pt"))
        mst, _ = ckpt.load_checkpoint(mask.init_state(0, device=dev),
                                      os.path.join(args.dir, "mask", "model_best.pt"))
        b = ds.batch(list(range(len(seeds))), device=dev)
        disp = joint.infer(jst, b.pred_flow, b.mesh)[2].float().cpu().numpy()
        attn_logit = mask.infer(mst, b.pred_flow, b.mesh)[2]
        attn = torch.sigmoid(attn_logit[..., 0].float()).cpu().numpy()
        vmask = b.mesh.vert_mask.cpu().numpy()
        verts_all = b.mesh.verts.cpu().numpy()
        for i, s in enumerate(seeds):
            vm = vmask[i]
            shifted = verts_all[i][vm] + np.tanh(disp[i])[vm]
            c = make_creature(s, target_verts=args.target_verts)
            inside = np.asarray(inside_check_np(shifted, voxelize_mesh(c.verts, c.faces)), bool)
            gt = ds.models[i].rig
            out[f"{split}{s}_shifted"] = shifted.astype(np.float32)
            out[f"{split}{s}_attn"] = attn[i][vm].astype(np.float32)
            out[f"{split}{s}_inside"] = inside
            out[f"{split}{s}_gtpos"] = gt.pos.astype(np.float32)
            print(f"[dump] {split} creature{s}: {vm.sum()} verts, "
                  f"{inside.sum()} inside, {gt.num_joints} GT joints")
    np.savez_compressed(os.path.join(args.dir, "joint_sweep_inputs.npz"), **out)
    print(f"[dump] wrote {args.dir}/joint_sweep_inputs.npz")
    return out


def feature_sizes(gt_pos: np.ndarray) -> np.ndarray:
    """Per GT joint, half the distance to its nearest other joint, clipped to
    [0.03, 0.10] (the campaign's rule)."""
    dj = np.linalg.norm(gt_pos[:, None] - gt_pos[None], axis=-1)
    np.fill_diagonal(dj, np.inf)
    return np.clip(0.5 * dj.min(1), 0.03, 0.10)


def normalized_attention(attn_raw: np.ndarray) -> np.ndarray:
    """Min-max over the creature's vertices; a constant attention as it is."""
    spread = attn_raw.max() - attn_raw.min()
    return ((attn_raw - attn_raw.min()) / spread if spread > 1e-10
            else attn_raw.astype(np.float64))


def cluster(shifted, attn, inside, q: float, keep: float, dev):
    """The points inside the volume whose normalized attention exceeds
    `keep`, reflected, then the bandwidth (quantile `q`, every row) and the
    mean-shift on `dev`: (moved (N,3), attention (N,), bandwidth, counts (N,)
    the NMS visiting order), or None below two points.  The counts are
    nms_modes' own formula, once for all (density, attn_nms) pairs."""
    from morig_tpu_torch.geometry.clustering import (estimate_bandwidth, meanshift_cluster,
                                                     symmetrize_reflect)

    sel = inside & (attn > keep)
    pts, a = shifted[sel], attn[sel]
    if len(pts) < 2:
        return None
    pts, a = symmetrize_reflect(pts.astype(np.float32), a)
    p = torch.as_tensor(pts, device=dev)[None]
    mask = torch.ones(p.shape[:2], dtype=torch.bool, device=dev)
    bw_t = estimate_bandwidth(p, mask, quantile=q)
    bw = float(bw_t[0])
    w = torch.as_tensor(a, dtype=torch.float32, device=dev)[None]
    moved = meanshift_cluster(p, bw_t, w, mask, MEANSHIFT_ITERS)[0].cpu().numpy()
    counts = (((moved[None] - moved[:, None]) ** 2).sum(-1) <= bw * bw).sum(0)
    return moved, a, bw, counts


def modes_of(clustered, dens: float, anms: float) -> np.ndarray:
    """NMS and flip of `cluster`'s output; no joint when it is None."""
    from morig_tpu_torch.geometry.clustering import flip_joints, nms_modes

    if clustered is None:
        return np.zeros((0, 3), np.float32)
    moved, a, bw, counts = clustered
    modes = nms_modes(moved, a, bw, dens, anms, counts=counts)
    return flip_joints(modes)[0]


def score(modes, gt_pos) -> dict:
    """The joint metrics (no joint: IoU 0, chamfer inf) and the joint count."""
    from morig_tpu_torch.eval.metrics import joint_match_metrics

    return dict(joint_match_metrics(modes, gt_pos, feature_sizes(gt_pos)), n_pred=len(modes))


def agg(ms) -> dict:
    return dict(
        mean_iou=float(np.mean([m["joint_IoU"] for m in ms])),
        min_iou=float(np.min([m["joint_IoU"] for m in ms])),
        mean_recall=float(np.mean([m["joint_recall"] for m in ms])),
        mean_precision=float(np.mean([m["joint_precision"] for m in ms])),
        mean_cd=float(np.mean([m["chamfer_j2j"] for m in ms])),
    )


def sweep(args, dev) -> dict:
    """Rank every (q, keep, density, attn_nms) on the validation creatures by
    mean IoU, then min IoU; evaluate the reference defaults and the best on
    the held-out creatures; write joint_sweep_result.json.  Returns
    {"ranked": [(cfg, agg)], "val": {cfg: per-creature metrics},
    "heldout": {"default"|"tuned": per-creature list}, "result": the JSON}."""
    from morig_tpu_torch.utils.profiling import device_info

    with np.load(os.path.join(args.dir, "joint_sweep_inputs.npz")) as z:
        data = {k: z[k] for k in z.files}

    quantiles = [float(x) for x in args.quantiles.split(",")]
    keeps = [float(x) for x in args.keeps.split(",")]
    densities = [float(x) for x in args.densities.split(",")]
    attn_nms = [float(x) for x in args.attn_nms.split(",")]

    def creature(split, s):
        return (data[f"{split}{s}_shifted"], normalized_attention(data[f"{split}{s}_attn"]),
                data[f"{split}{s}_inside"], data[f"{split}{s}_gtpos"])

    val_results: dict = {}
    for s in VAL_SEEDS:
        shifted, attn, inside, gt_pos = creature("val", s)
        for q, keep in itertools.product(quantiles, keeps):
            c = cluster(shifted, attn, inside, q, keep, dev)
            for dens, anms in itertools.product(densities, attn_nms):
                val_results.setdefault((q, keep, dens, anms), []).append(
                    score(modes_of(c, dens, anms), gt_pos))
        print(f"[sweep] val creature{s} done")

    ranked = sorted(((cfg, agg(ms)) for cfg, ms in val_results.items()),
                    key=lambda kv: (-kv[1]["mean_iou"], -kv[1]["min_iou"]))
    print("\n[sweep] top-10 on validation (q, keep, density, attn_nms):")
    for cfg, a in ranked[:10]:
        print(f"  q={cfg[0]:.3f} keep={cfg[1]:.2f} dens={cfg[2]:.3f} "
              f"anms={cfg[3]:.2f}: IoU={a['mean_iou']:.3f} "
              f"min={a['min_iou']:.3f} P={a['mean_precision']:.3f} "
              f"R={a['mean_recall']:.3f} CD={a['mean_cd']:.4f}")
    if DEFAULT_KEY in val_results:
        a = agg(val_results[DEFAULT_KEY])
        print(f"  [reference defaults] IoU={a['mean_iou']:.3f} "
              f"min={a['min_iou']:.3f}")

    best = ranked[0][0]
    print(f"\n[sweep] best on val: q={best[0]} keep={best[1]} "
          f"dens={best[2]} anms={best[3]}")

    # held-out evaluation at the reference defaults and at the chosen config
    heldout, result = {}, None
    for name, cfg in (("default", DEFAULT_KEY), ("tuned", best)):
        q, keep, dens, anms = cfg
        per = []
        for s in TEST_SEEDS:
            shifted, attn, inside, gt_pos = creature("te", s)
            m = score(modes_of(cluster(shifted, attn, inside, q, keep, dev), dens, anms), gt_pos)
            n_pred = m.pop("n_pred")
            per.append(dict(seed=s, n_pred=n_pred, n_gt=len(gt_pos), **m))
        heldout[name] = per
        a = agg(per)
        print(f"\n[sweep] held-out @ {name} "
              f"(q={q} keep={keep} dens={dens} anms={anms}):")
        for p in per:
            print(f"  creature{p['seed']}: J={p['n_pred']}/{p['n_gt']} "
                  f"IoU={p['joint_IoU']:.3f} P={p['joint_precision']:.3f} "
                  f"R={p['joint_recall']:.3f} CD={p['chamfer_j2j']:.4f}")
        print(f"  mean IoU={a['mean_iou']:.3f} min={a['min_iou']:.3f} "
              f"P={a['mean_precision']:.3f} R={a['mean_recall']:.3f} "
              f"CD={a['mean_cd']:.4f}")
        if name == "tuned":
            result = dict(best=dict(bandwidth_quantile=q, attn_threshold=keep,
                                    density_threshold=dens, attn_nms_threshold=anms,
                                    bandwidth_sample_rows=0),
                          heldout=per, heldout_agg=a, device=device_info(dev))
            with open(os.path.join(args.dir, "joint_sweep_result.json"), "w") as f:
                json.dump(result, f, indent=1)
            print(f"[sweep] wrote {args.dir}/joint_sweep_result.json")
    return dict(ranked=ranked, val=val_results, heldout=heldout, result=result)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default="campaign_v3")
    ap.add_argument("--dump", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the dump's inference and the sweep's mean-shift "
                         "(default cuda, the card; 'cpu' runs the kernels' plain versions)")
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--target-verts", type=int, default=1900)
    ap.add_argument("--quantiles", default="0.03,0.04,0.05,0.06")
    ap.add_argument("--keeps", default="0.1,0.2,0.3")
    ap.add_argument("--densities", default="0.02,0.035,0.05")
    ap.add_argument("--attn-nms", default="0.7,0.85,1.01")
    return ap


def main(argv=None):
    from morig_tpu_torch.cli import _device

    args = build_parser().parse_args(argv)
    dev = _device(args)
    t0 = time.perf_counter()
    out = dump(args, dev) if args.dump else sweep(args, dev)
    print(f"[{'dump' if args.dump else 'sweep'}] {time.perf_counter() - t0:.1f} s")
    return out


if __name__ == "__main__":
    main()
