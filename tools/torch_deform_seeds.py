"""The campaign's DeformNet stage (tools/torch_campaign.py stage 2) over
several seeds, from one trained CorrNet: how often its early stopping ends
the stage on an early dip of the val loss, and where its best val loss
lands against campaign_v4's band.

    python3 tools/torch_deform_seeds.py --corr <campaign dir>/corr/model_best.pt \
        --dir <scratch dir> --seeds 0,1,2,3 [--tree <checkout>] [--out result.json]

Each seed s trains `DeformPoseStage` as the campaign does (campaign_v4's
220 epochs, patience 60, batch 4, the campaign's pose datasets; the
extractor taken from the CorrNet checkpoint and frozen) from
`init_state(s)`, with `train_stage(seed=s)`'s schedules and draws: seed 0
is the campaign's own deform stage.  `--tree` imports tools/torch_campaign.py
and morig_tpu_torch from another checkout (a parent unpacked with `git
archive`), so two versions of the port train from one CorrNet in one call.
Prints, and writes to `--out`, one JSON object per seed: the best val loss
and its epoch, the epochs run, the val loss at epoch 5, the least val loss
over epochs 6-72, and whether the best lies inside the band.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

BAND = 0.0213                 # PR 19's band for the deform stage's best val loss


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--corr", required=True, help="a CorrNet checkpoint (model_best.pt)")
    ap.add_argument("--dir", required=True, help="where each seed's stage writes")
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="the campaign's --smoke sizes")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "tools"))
    import torch_campaign as tc                      # puts the tree's root first on sys.path
    import torch

    from morig_tpu_torch.data.creature import creature_pose_dataset
    from morig_tpu_torch.train import checkpoint as ckpt
    from morig_tpu_torch.train.scanned import pose_scan_batcher, with_val_dataset
    from morig_tpu_torch.train.stages import CorrPoseStage, DeformPoseStage

    dev = torch.device(args.device)
    z = tc.sizes(tc.build_parser().parse_args(["--smoke"] if args.smoke else []))
    tr, val = (creature_pose_dataset(num_models=len(s), seed=s[0], num_frames=tc.POSE_FRAMES,
                                     num_points=z["n_pts"], target_verts=z["tv"])
               for s in (z["train"], z["val"]))
    batcher = with_val_dataset(
        pose_scan_batcher(tr, z["bs"], "modelsresource", False, device=dev),
        pose_scan_batcher(val, z["bs"], "modelsresource", False, device=dev))
    corr_state, _ = ckpt.load_checkpoint(CorrPoseStage().init_state(0, device=dev), args.corr)
    results = []
    for seed in (int(s) for s in args.seeds.split(",")):
        deform = DeformPoseStage()
        state0 = deform.init_extractor_from(deform.init_state(seed, device=dev), corr_state)
        name = f"deform_seed{seed}"
        tc.train_stage(deform, name, args.dir, z["E"]["deform"], batcher, dev, seed=seed,
                       resume_state=state0, patience=z["P"]["deform"])
        with open(os.path.join(args.dir, name, "metrics.jsonl")) as f:
            vals = [r["total_loss"] for r in map(json.loads, f) if r.get("split") == "val"]
        best = min(range(len(vals)), key=vals.__getitem__)
        row = dict(tree=os.path.abspath(args.tree), seed=seed, best_val=vals[best],
                   best_epoch=best + 1, epochs_run=len(vals),
                   val_epoch5=vals[4] if len(vals) > 4 else None,
                   least_val_6_72=min(vals[5:72], default=None),
                   in_band=vals[best] <= BAND)
        print(json.dumps(row), flush=True)
        results.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
