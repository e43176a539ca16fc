"""One sharded training step over n ranks — counterpart of the JAX package's
multichip dry run (`__graft_entry__.dryrun_multichip`).

    python -m morig_tpu_torch.parallel.dryrun 4                 # NCCL, one card per rank
    python -m morig_tpu_torch.parallel.dryrun 4 --backend gloo  # the ranks share the cards
    python -m morig_tpu_torch.parallel.dryrun 4 --device cpu    # gloo on the CPU

It runs where the caller says: on the cards unless `device="cpu"`, over
NCCL there unless the caller names gloo; it never moves itself to another
device or backend.
"""
from __future__ import annotations

import argparse
import math
from typing import Optional

import torch

from morig_tpu_torch.parallel.sharding import make_device_mesh, shard_batch, shard_state, spawn


def _tiny_batch(num_models: int, device):
    """The JAX dry run's input: one capsule (64 points, 7 x 6 rings) per
    data shard, frames (0, 2)."""
    from morig_tpu_torch.data.pose import capsule_pose_dataset

    ds = capsule_pose_dataset(num_models=num_models, num_frames=4, num_points=64, n_lat=7,
                              n_lon=6)
    return ds.batch(list(range(num_models)), 0, 2, device=device)


def _dryrun_rank(rank: int, device, data: int, model: int) -> dict:
    from morig_tpu_torch.train.stages import DeformPoseStage

    mesh = make_device_mesh(data, model)
    stage = DeformPoseStage()
    state = shard_state(stage.init_state(0, device=device), mesh, tensor_parallel=True,
                        reinit_opt=True)
    batch = shard_batch(_tiny_batch(data, device), mesh)
    metrics = stage.train_step(state, batch, torch.Generator(device=device).manual_seed(1),
                               mesh=mesh)
    return dict(metrics, data_index=mesh.data_index, model_index=mesh.model_index)


def dryrun_multichip(n: int, device: str = "cuda", backend: Optional[str] = None) -> dict:
    """One DeformPoseStage step (tensor-parallel wide layers, a fresh
    optimizer) on a data x model mesh of n ranks, model = 2 where n is
    even: one capsule per data shard.  `backend` None is NCCL on the cards
    and gloo on the CPU.  Prints one line and returns rank 0's metrics."""
    model = 2 if n % 2 == 0 else 1
    data = n // model
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        from morig_tpu_torch.kernels import build as kb

        kb.build()                       # once, before the ranks load it
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())][:n]
    else:
        devices = ["cpu"]
    results = spawn(_dryrun_rank, n, backend, devices, args=(data, model),
                    threads=None if device.type == "cuda" else 1)
    loss = results[0]["total_loss"]
    if not all(math.isfinite(r["total_loss"]) and r["total_loss"] == loss for r in results):
        raise AssertionError(f"dryrun_multichip({n}): the ranks' losses differ or are not "
                             f"finite: {[r['total_loss'] for r in results]}")
    print(f"dryrun_multichip({n}): mesh data={data} model={model} backend={backend} "
          f"devices={','.join(str(d) for d in devices)} train_step ok, loss={loss:.4f}")
    return results[0]


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n", type=int)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    args = parser.parse_args()
    dryrun_multichip(args.n, args.device, args.backend)
