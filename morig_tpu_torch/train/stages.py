"""Training stages: model + losses + train/eval steps — counterpart of
morig_tpu/train/stages.py.  So far the correspondence stage,
`CorrPoseStage`.

A train step is one forward in training numerics (fp32 matmuls, every edge
layer through K1 forward and K6 backward, the vismask 1-NN through K2 with
its autograd backward, plain indexed gathers in PointNet++), one
`backward()`, a global-norm clip and one optimizer step.
"""
from __future__ import annotations

from typing import Optional

import torch

from morig_tpu_torch.core.batch import PoseSample
from morig_tpu_torch.core.config import DEFAULT_CONFIG, Config
from morig_tpu_torch.losses.basic import bce_with_logits
from morig_tpu_torch.losses.nce import info_nce
from morig_tpu_torch.nn.corrnet import CorrNet
from morig_tpu_torch.nn.mlp import init_parameters
from morig_tpu_torch.train import trainer


def _floats(metrics: dict) -> dict[str, float]:
    """Device scalars to floats with one transfer."""
    values = torch.stack([v.detach().float() for v in metrics.values()]).tolist()
    return dict(zip(metrics, values))


class CorrPoseStage:
    """CorrNet training on pose pairs: infoNCE + 5 x BCE(vismask), with the
    visibility branch trained from `vis_branch_start_epoch` on."""

    def __init__(self, cfg: Config = DEFAULT_CONFIG):
        self.cfg = cfg
        self.train_vismask = False
        self.vis_branch_start_epoch = cfg.train.vis_branch_start_epoch

    def on_epoch(self, epoch: int):
        if epoch >= self.vis_branch_start_epoch:
            self.train_vismask = True

    def make_tx(self, params, steps_per_epoch: int = 1) -> trainer.MultiStepAdam:
        t = self.cfg.train
        return trainer.multistep_adam(params, t.lr, t.schedule, t.gamma, t.weight_decay,
                                      steps_per_epoch)

    def init_state(self, seed: int = 0, device="cuda") -> trainer.TrainState:
        """A fresh CorrNet (flax's initializers, drawn from `seed`) on
        `device` (the card unless the caller asks for another), with its
        optimizer."""
        m = self.cfg.model
        model = CorrNet(m.corr_output_feature, m.tau_nce)
        init_parameters(model, torch.Generator().manual_seed(seed))
        model = model.to(device)
        return trainer.TrainState(model, self.make_tx(model.parameters()))

    def _losses(self, outputs, batch: PoseSample, train_vismask: bool):
        vtx_f, pts_f, vis_logits, tau = outputs
        c = batch.corr
        loss_match = info_nce(vtx_f, pts_f, c.v2p, c.v2p_mask, c.p2v, c.p2v_mask,
                              batch.mesh.vert_mask, batch.points.pts_mask, tau)
        if train_vismask:
            loss_mask = bce_with_logits(vis_logits[..., 0], batch.vismask, batch.mesh.vert_mask)
        else:
            loss_mask = torch.zeros((), device=loss_match.device)
        total = loss_match + 5.0 * loss_mask
        return total, dict(corr_loss=loss_match, vis_loss=loss_mask, total_loss=total)

    def train_step(self, state: trainer.TrainState, batch: PoseSample,
                   generator: Optional[torch.Generator] = None) -> dict[str, float]:
        """One optimizer step on `batch`; FPS starts are drawn from
        `generator` (index 0 when None).  Returns the losses and the global
        gradient norm before the clip (`grad_norm`)."""
        outputs = state.model(batch.mesh, batch.points, train=True,
                              train_vismask=self.train_vismask, generator=generator)
        total, metrics = self._losses(outputs, batch, self.train_vismask)
        state.tx.zero_grad()
        total.backward()
        metrics["grad_norm"] = state.apply_gradients()
        return _floats(metrics)

    @torch.no_grad()
    def eval_step(self, state: trainer.TrainState, batch: PoseSample) -> dict[str, float]:
        outputs = state.model(batch.mesh, batch.points, train=False,
                              train_vismask=self.train_vismask)
        return _floats(self._losses(outputs, batch, self.train_vismask)[1])

    @torch.no_grad()
    def infer(self, state: trainer.TrainState, batch: PoseSample, train_vismask: bool = True):
        """The inference forward: (vtx_f, pts_f, vis_logits, tau)."""
        return state.model(batch.mesh, batch.points, train=False, train_vismask=train_vismask)
