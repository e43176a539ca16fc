"""Does the motion-embedding loss of morig_tpu_torch's SkinStage learn on the
card, and what moves it: the input flows, the draws or the numerics?

    PYTHONPATH=. python3 tools/torch_skin_embed_probe.py [--epochs 40] [--seeds 0,1,2,3]
        [--flows campaign_dir/pred_flows.npz] [--forms scanned,bf16_narrow,fp32_edge,loop]

In the campaign (tools/torch_campaign.py) the skin stage's `loss_motion`
(0.01 x the multi-positive infoNCE of the motion features) may stay at its
value for collapsed features (~0.3182), where campaign_v4's JAX run lowers
it below 0.3170 by epoch 7.  This trains SkinStage from seeded inits on the
campaign's creatures (12 training, 3 validation, batch 4,
`num_embed_sample` 512) with two sources of input flows:

  gt    `creature_rig_dataset`'s noisy GT flows (gt_flow plus seeded noise);
  pred  with --flows, the flows a campaign's DeformNet dumped
        (<dir>/pred_flows.npz, its "tr" and "val" splits), which the
        campaign's skin stage trains on;

and in these forms, each with its own `seed` (the init, the draws'
generator and the schedule):

  scanned      run_epochs_scanned (each step a CUDA-graph replay), the
               package's training numerics: layers narrower than 128 in
               fp32 (`narrow_edge_trainable`), the others through K1 + K6, the
               JAX package's split;
  bf16_narrow  scanned, every edge layer the kernels take through K1 + K6 on
               bf16 operands, the narrow ones too (the port's training
               before it took the JAX split; patched here only);
  fp32_edge    scanned, every edge layer's tail in fp32 (no bf16 rounding,
               no K1/K6): KN + KNB below 128, their plain version by
               autograd at 128 and 256, which KN and KNB do not take;
  loop         run_epochs (eager steps): the graphs' part.

One JSON line per (source, form, seed) with the per-epoch train and val
`loss_motion` and `loss_skin`, the first epoch whose val `loss_motion` is
below 0.3170 (`escape`, null if none) and its least value; then a table of
the escapes by source x form x seed, and the card's name and power limit.
The probe measures the card: it exits without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from morig_tpu_torch.data.creature import creature_rig_dataset  # noqa: E402
from morig_tpu_torch.kernels.narrow_edge import (  # noqa: E402
    NARROW_WIDTHS, narrow_edge_plain, narrow_edge_trainable)
from morig_tpu_torch.nn import gcu  # noqa: E402
from morig_tpu_torch.train import scanned, trainer  # noqa: E402
from morig_tpu_torch.train.stages import SkinStage  # noqa: E402

ESCAPE = 0.3170            # below the collapsed value ~0.3182; v4's val left it at epoch 6-7
FORMS = ("scanned", "bf16_narrow", "fp32_edge", "loop")
TRAIN, VAL = (12, 0), (3, 100)        # (creatures, first seed) of the campaign's rig sets


def all_narrow(*args, rev=None, **_):
    """Every edge layer's training tail in fp32: `narrow_edge_trainable` at the widths
    KN and KNB take, their plain version (autograd) at the others."""
    if args[0].shape[-1] in NARROW_WIDTHS:
        return narrow_edge_trainable(*args, rev=rev)
    return narrow_edge_plain(*args)


class Records(trainer.MetricLogger):
    def __init__(self):
        super().__init__(None)
        self.rows = []

    def log(self, epoch, split, metrics, time_s=None, **extra):
        self.rows.append((epoch, split, metrics))


def patched(form: str, model):
    """The model's edge layers set for `form`; returns a function that puts
    them back."""
    edges = [m for m in model.modules() if isinstance(m, gcu.EdgeMLP)]
    routes = [m.train_route for m in edges]
    trainable = gcu.fused_edge_mlp_trainable
    if form == "bf16_narrow":
        for m in edges:
            if m.kernel_route:
                m.train_route = "kernel"
    elif form == "fp32_edge":
        gcu.fused_edge_mlp_trainable = all_narrow

    def restore():
        gcu.fused_edge_mlp_trainable = trainable
        for m, r in zip(edges, routes):
            m.train_route = r
    return restore


def run(form: str, source: str, tr, va, epochs: int, seed: int, dev) -> dict:
    stage = SkinStage(num_embed_sample=min(512, tr.pad_verts))
    state = stage.init_state(seed, device=dev)
    restore = patched(form, state.model)
    try:
        gen, rng_np, log = torch.Generator(device=dev).manual_seed(seed + 1), \
            np.random.default_rng(seed), Records()
        t0 = time.time()
        if form == "loop":
            trainer.run_epochs(stage, state, lambda e: tr.epoch_batches(rng_np, 4, True, dev),
                               lambda: va.epoch_batches(rng_np, 4, False, dev), None, epochs,
                               logger=log, generator=gen)
        else:
            scanned.run_epochs_scanned(stage, state, scanned.rig_scan_batcher(tr, 4, va, dev),
                                       epochs=epochs, logger=log, generator=gen,
                                       rng_np=rng_np, chunk_epochs=24)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.time() - t0
    finally:
        restore()
    series = {f"{split}_{k}": [round(m[k], 6) for _, s, m in log.rows if s == split]
              for split in ("train", "val") for k in ("loss_motion", "loss_skin")}
    val = series["val_loss_motion"]
    escape = next((e for e, v in enumerate(val) if v < ESCAPE), None)
    return dict(source=source, form=form, seed=seed, epochs=epochs, seconds=round(seconds, 1),
                escape=escape, least_val_loss_motion=min(val) if val else None, **series)


def load_pred_flows(path: str) -> tuple[list, list]:
    """The "tr" and "val" flows of a campaign's pred_flows.npz (one (V, 3T)
    array per creature), as tools/torch_campaign.py writes them."""
    with np.load(path) as z:
        return ([z[f"tr{i}"] for i in range(TRAIN[0])], [z[f"val{i}"] for i in range(VAL[0])])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--forms", default="scanned,bf16_narrow,fp32_edge")
    ap.add_argument("--flows", default=None,
                    help="a campaign's pred_flows.npz: also train on its flows")
    args = ap.parse_args(argv)
    forms = args.forms.split(",")
    if any(f not in FORMS for f in forms):
        raise SystemExit(f"forms are {FORMS}, got {forms}")
    if not torch.cuda.is_available():
        raise SystemExit("the probe measures the card: no CUDA device is available")
    dev = torch.device("cuda", 0)
    sources = {"gt": (None, None)}
    if args.flows:
        sources["pred"] = load_pred_flows(args.flows)
    table = []
    for source, (ftr, fva) in sources.items():
        tr = creature_rig_dataset(num_models=TRAIN[0], seed=TRAIN[1], num_points=1024,
                                  pred_flows=ftr, device=dev)
        va = creature_rig_dataset(num_models=VAL[0], seed=VAL[1], num_points=1024,
                                  pred_flows=fva, device=dev)
        for form in forms:
            for seed in (int(s) for s in args.seeds.split(",")):
                r = run(form, source, tr, va, args.epochs, seed, dev)
                print(json.dumps(r), flush=True)
                table.append(r)
    print(f"first epoch of val loss_motion < {ESCAPE} (least value), {args.epochs} epochs:")
    for r in table:
        print(f"  {r['source']:4s} {r['form']:11s} seed {r['seed']}: escape {r['escape']} "
              f"({r['least_val_loss_motion']})")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
