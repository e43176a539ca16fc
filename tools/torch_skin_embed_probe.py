"""Does the motion-embedding loss of morig_tpu_torch's SkinStage learn on the
card, and what moves it?

    PYTHONPATH=. python3 tools/torch_skin_embed_probe.py [--epochs 40] [--seed 0]

In the campaign (tools/torch_campaign.py) the skin stage's `loss_motion`
(0.01 x the multi-positive infoNCE of the motion features) stays at its
value for collapsed features, where campaign_v4's JAX run lowers it.  This
trains SkinStage from one seeded init on the campaign's creatures (12
training, 3 validation, `creature_rig_dataset`'s noisy GT flows as input
flows, batch 4, `num_embed_sample` 512) in four forms, each printing
`loss_motion` and `loss_skin` of its train and val epochs:

  scanned    run_epochs_scanned (each step a CUDA-graph replay), as the campaign;
  loop       run_epochs (eager steps): the graphs' part;
  fp32_edge  scanned, every edge layer's tail in fp32 autograd (no bf16
             rounding, no K1/K6): the port's bf16 edge messages' part;
  fp32_narrow scanned, the edge layers narrower than 128 in fp32 autograd
             and the rest through K1 + K6: the JAX package's training split
             (its XLA path below 128, its kernels from 128).

One JSON line per form with the per-epoch values, then the card's name and
power limit.
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
from morig_tpu_torch.kernels import edge_fused  # noqa: E402
from morig_tpu_torch.nn import gcu  # noqa: E402
from morig_tpu_torch.train import scanned, trainer  # noqa: E402
from morig_tpu_torch.train.stages import SkinStage  # noqa: E402


def edge_fp32(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, **_):
    """The edge tail in fp32 throughout, differentiated by autograd."""
    h = torch.relu(a.float()[:, :, None, :] + edge_fused._gather(b, nbr))
    h = edge_fused.layer_norm(h, g1, be1)
    h2 = edge_fused.layer_norm(torch.relu(torch.matmul(h, w2) + b2), g2, be2)
    h2 = torch.where(mask[..., None], h2, torch.full_like(h2, -1e30))
    out = h2.max(dim=2).values
    return torch.where(mask.any(dim=2)[..., None], out, torch.zeros_like(out))


class Records(trainer.MetricLogger):
    def __init__(self):
        super().__init__(None)
        self.rows = []

    def log(self, epoch, split, metrics, time_s=None, **extra):
        self.rows.append((epoch, split, metrics))


def run(form: str, tr, va, epochs: int, seed: int, dev) -> dict:
    trainable = gcu.fused_edge_mlp_trainable
    if form == "fp32_edge":
        gcu.fused_edge_mlp_trainable = edge_fp32
    elif form == "fp32_narrow":
        gcu.fused_edge_mlp_trainable = lambda a, *r, **k: (
            edge_fp32(a, *r) if a.shape[-1] < 128 else trainable(a, *r, **k))
    try:
        stage = SkinStage(num_embed_sample=min(512, tr.pad_verts))
        state = stage.init_state(seed, device=dev)
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
        gcu.fused_edge_mlp_trainable = trainable
    series = {f"{split}_{k}": [round(m[k], 6) for _, s, m in log.rows if s == split]
              for split in ("train", "val") for k in ("loss_motion", "loss_skin")}
    return dict(form=form, epochs=epochs, seconds=seconds, **series)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--forms", default="scanned,loop,fp32_edge,fp32_narrow")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the probe measures the card: no CUDA device is available")
    dev = torch.device("cuda", 0)
    tr = creature_rig_dataset(num_models=12, seed=0, num_points=1024, device=dev)
    va = creature_rig_dataset(num_models=3, seed=100, num_points=1024, device=dev)
    for form in args.forms.split(","):
        print(json.dumps(run(form, tr, va, args.epochs, args.seed, dev)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
