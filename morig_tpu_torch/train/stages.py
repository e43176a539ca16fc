"""Training stages: model + losses + train/eval steps — counterpart of
morig_tpu/train/stages.py: the correspondence stage `CorrPoseStage`, the
flow stage `DeformPoseStage`, the joint and mask stage `RigStage`, the
skinning stage `SkinStage`, and the skeleton stages `BoneStage` (pair
connectivity) and `RootStage` (the root joint).

A train step is one forward in training numerics (fp32 matmuls, every edge
layer through K1 forward and K6 backward, the kNN calls through K2 with its
autograd backward, plain indexed gathers in PointNet++), one `backward()`,
a global-norm clip at 10 over the trained parameters and one optimizer
step.  It returns its losses and the gradient norm as floats, read with
one transfer, or with `on_device=True` as device scalars, read by nothing
(`eval_step` too): the form the scanned runner captures in a CUDA graph
(train/scanned.py, train/graphs.py).

In "batch" norm mode (`nn.mlp.set_default_norm`) the train step's forward
normalizes with batch statistics and updates the running statistics (the
JAX steps' `mutable=["batch_stats"]`); `eval_step` and `infer` normalize
with the running statistics.  A frozen DeformNet extractor runs on batch
statistics too, but its running statistics are put back after the
forward: they stay those of the loaded CorrNet.

Every `train_step` and `eval_step` takes an optional `mesh`
(parallel/sharding.py `make_device_mesh`): the rank then steps on its rows
of the global batch (`shard_batch`) with a state placed by `shard_state`,
and the step is the one-device step on the global batch, under
parallel/mesh.py's convention: the losses are this rank's share, the
gradients and the reported losses are summed over the data group.
Without a mesh a step is the one-device step, bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from morig_tpu_torch.core.batch import PoseSample, RigSample, SkelSample
from morig_tpu_torch.core.config import DEFAULT_CONFIG, Config
from morig_tpu_torch.kernels.neighbors import pairwise_sqdist
from morig_tpu_torch.losses.basic import (
    batched_chamfer_with_average, bce_with_logits, chamfer_directional, cross_entropy_with_probs,
    masked_l1, masked_l1_weighted)
from morig_tpu_torch.losses.nce import info_nce, multi_pos_info_nce
from morig_tpu_torch.nn.bonenet import BoneNet, RootNet
from morig_tpu_torch.nn.corrnet import CorrNet
from morig_tpu_torch.nn.deformnet import DeformNet
from morig_tpu_torch.nn.mlp import init_parameters
from morig_tpu_torch.nn.rignet import JointNetMotion, MaskNetMotion, SkinMotion
from morig_tpu_torch.parallel import active, batch_mean, batch_sum
from morig_tpu_torch.parallel.mesh import all_reduce_
from morig_tpu_torch.train import trainer


def _floats(metrics: dict) -> dict[str, float]:
    """Device scalars to floats with one transfer."""
    values = torch.stack([v.detach().float() for v in metrics.values()]).tolist()
    return dict(zip(metrics, values))


def _summed(metrics: dict, mesh) -> dict:
    """The metrics summed over the mesh's data group (unchanged without
    one): each rank's losses are its share of the global ones."""
    if mesh is None or mesh.data == 1:
        return metrics
    values = torch.stack([v.detach().float() for v in metrics.values()])
    return dict(zip(metrics, all_reduce_(values, mesh.data_group, mesh.data).unbind()))


def _out(metrics: dict, on_device: bool) -> dict:
    """The step's metrics: floats read with one transfer, or with
    `on_device` the device scalars themselves (fp32, no host sync: the
    scanned runner's form, train/scanned.py)."""
    if on_device:
        return {k: v.detach().float() for k, v in metrics.items()}
    return _floats(metrics)


def _step(state: trainer.TrainState, total: torch.Tensor, metrics: dict,
          mesh=None, on_device: bool = False) -> dict:
    """backward(), the clip and one optimizer step; the metrics (`_out`)
    with the gradient norm before the clip (`grad_norm`)."""
    state.tx.zero_grad()
    total.backward()
    metrics = _summed(metrics, mesh)
    metrics["grad_norm"] = state.apply_gradients(mesh)
    return _out(metrics, on_device)


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
                   generator: Optional[torch.Generator] = None, mesh=None,
                   on_device: bool = False) -> dict:
        """One optimizer step on `batch`; FPS starts are drawn from
        `generator` (index 0 when None).  Returns the losses and the global
        gradient norm before the clip (`grad_norm`)."""
        with active(mesh):
            outputs = state.model(batch.mesh, batch.points, train=True,
                                  train_vismask=self.train_vismask, generator=generator)
            losses = self._losses(outputs, batch, self.train_vismask)
        return _step(state, *losses, mesh, on_device)

    @torch.no_grad()
    def eval_step(self, state: trainer.TrainState, batch: PoseSample,
                  mesh=None, on_device: bool = False) -> dict:
        with active(mesh):
            outputs = state.model(batch.mesh, batch.points, train=False,
                                  train_vismask=self.train_vismask)
            metrics = self._losses(outputs, batch, self.train_vismask)[1]
        return _out(_summed(metrics, mesh), on_device)

    @torch.no_grad()
    def infer(self, state: trainer.TrainState, batch: PoseSample, train_vismask: bool = True):
        """The inference forward: (vtx_f, pts_f, vis_logits, tau)."""
        return state.model(batch.mesh, batch.points, train=False, train_vismask=train_vismask)


def _default_generator(generator: Optional[torch.Generator], device) -> torch.Generator:
    return generator if generator is not None else torch.Generator(device=device).manual_seed(0)


class DeformPoseStage:
    """DeformNet training: L1 flow loss with the CorrNet extractor frozen by
    default (its parameters take no gradient and stay out of the optimizer,
    so the clip's global norm runs over the trained parameters only);
    `train_extractor=True` also trains the extractor with infoNCE and the
    visibility BCE on probabilities."""

    def __init__(self, cfg: Config = DEFAULT_CONFIG, train_extractor: bool = False):
        self.cfg = cfg
        self.train_extractor = train_extractor

    def on_epoch(self, epoch: int):
        pass

    def make_tx(self, params, steps_per_epoch: int = 1) -> trainer.MultiStepAdam:
        t = self.cfg.train
        return trainer.multistep_adam(params, t.lr, t.schedule, t.gamma, t.weight_decay,
                                      steps_per_epoch)

    def init_state(self, seed: int = 0, device="cuda") -> trainer.TrainState:
        """A fresh DeformNet (drawn from `seed`) on `device` (the card unless
        the caller asks for another), the extractor frozen unless
        train_extractor, with its optimizer over the trained parameters."""
        m = self.cfg.model
        model = DeformNet(m.num_interp, m.tau_nce, m.corr_output_feature,
                          generator=torch.Generator().manual_seed(seed)).to(device)
        model.corr_extractor.requires_grad_(self.train_extractor)
        return trainer.TrainState(model, self.make_tx(
            [p for p in model.parameters() if p.requires_grad]))

    def init_extractor_from(self, state: trainer.TrainState,
                            corr_state: trainer.TrainState) -> trainer.TrainState:
        """Load a CorrNet state's weights into the extractor (strict: every
        key present, none extra, shapes equal), the counterpart of the JAX
        package's `transfer_subtree`; the extractor keeps its
        requires_grad."""
        state.model.corr_extractor.load_state_dict(corr_state.model.state_dict(), strict=True)
        return state

    def _losses(self, outputs, batch: PoseSample):
        pred_flow, vtx_f, pts_f, vis, tau = outputs
        vert_mask = batch.mesh.vert_mask
        loss_flow = masked_l1(pred_flow, batch.gt_flow, vert_mask)
        metrics = dict(flow_loss=loss_flow)
        total = loss_flow
        if self.train_extractor:
            c = batch.corr
            loss_match = info_nce(vtx_f, pts_f, c.v2p, c.v2p_mask, c.p2v, c.p2v_mask,
                                  vert_mask, batch.points.pts_mask, tau)
            # vis is a probability here: the BCE of its log
            eps = 1e-6
            vis_c = torch.clamp(vis, eps, 1 - eps)
            per = -(batch.vismask * torch.log(vis_c)
                    + (1 - batch.vismask) * torch.log(1 - vis_c))
            m = vert_mask.to(per.dtype)
            loss_vis = (per * m).sum() / torch.clamp(batch_sum(m.sum()), min=1.0)
            total = loss_flow + loss_match + 5.0 * loss_vis
            metrics.update(corr_loss=loss_match, vis_loss=loss_vis)
        metrics["total_loss"] = total
        return total, metrics

    def train_step(self, state: trainer.TrainState, batch: PoseSample,
                   generator: Optional[torch.Generator] = None, mesh=None,
                   on_device: bool = False) -> dict:
        """One optimizer step on `batch`; the extractor's FPS starts are drawn
        from `generator` (index 0 when None).  With the extractor frozen its
        running statistics ("batch" norm mode) are restored after the
        forward, as the JAX stage's `_keep_frozen_stats` does."""
        frozen = [] if self.train_extractor else list(state.model.corr_extractor.buffers())
        saved = [b.clone() for b in frozen]
        with active(mesh):
            outputs = state.model(batch.mesh, batch.points, train=True, generator=generator)
            with torch.no_grad():
                for b, old in zip(frozen, saved):
                    b.copy_(old)
            losses = self._losses(outputs, batch)
        return _step(state, *losses, mesh, on_device)

    @torch.no_grad()
    def eval_step(self, state: trainer.TrainState, batch: PoseSample,
                  mesh=None, on_device: bool = False) -> dict:
        with active(mesh):
            metrics = self._losses(state.model(batch.mesh, batch.points), batch)[1]
        return _out(_summed(metrics, mesh), on_device)

    @torch.no_grad()
    def infer(self, state: trainer.TrainState, batch: PoseSample):
        """The inference forward: (pred_flow, vtx_f, pts_f, vis, tau)."""
        return state.model(batch.mesh, batch.points)


class _MotionStage:
    """What the rig and skin stages share: the optimizer (lr 5e-4,
    milestones 40 and 80, gamma 0.2), the 50/50 draw between the GT and
    the predicted input flow, the motion-embedding loss over the T
    keyframe embeddings and their aggregate, and the steps around each
    subclass's `_forward(model, batch, input_flow, train)` and
    `_losses(generator, outputs, batch)`."""

    def __init__(self, cfg: Config, num_embed_sample: int):
        self.cfg = cfg
        self.num_embed_sample = num_embed_sample

    def on_epoch(self, epoch: int):
        pass

    def make_tx(self, params, steps_per_epoch: int = 1) -> trainer.MultiStepAdam:
        return trainer.multistep_adam(params, 5e-4, (40, 80), 0.2, self.cfg.train.weight_decay,
                                      steps_per_epoch)

    def _state(self, model: torch.nn.Module, device) -> trainer.TrainState:
        model = model.to(device)
        return trainer.TrainState(model, self.make_tx(model.parameters()))

    @staticmethod
    def input_flow(batch: RigSample, generator: torch.Generator) -> torch.Tensor:
        """gt_flow or pred_flow with probability 1/2 each: one draw on the
        batch's device, read by no host code."""
        use_gt = torch.rand((), generator=generator, device=batch.gt_flow.device) > 0.5
        return torch.where(use_gt, batch.gt_flow, batch.pred_flow)

    def _embed_loss(self, generator, motion_all, motion_aggr, batch: RigSample):
        feats = [motion_all[:, :, t, :] for t in range(motion_all.shape[2])] + [motion_aggr]
        return sum(multi_pos_info_nce(generator, f, batch.gt_skin, batch.mesh.vert_mask,
                                      num_sample=self.num_embed_sample) for f in feats)

    def train_step(self, state: trainer.TrainState, batch: RigSample,
                   generator: Optional[torch.Generator] = None, mesh=None,
                   on_device: bool = False) -> dict:
        """One optimizer step on `batch`: the input flow and the embedding
        loss's samples are drawn from `generator` (a fresh one seeded 0 on
        the batch's device when None)."""
        generator = _default_generator(generator, batch.gt_flow.device)
        with active(mesh):
            flow = self.input_flow(batch, generator)
            outputs = self._forward(state.model, batch, flow, True)
            losses = self._losses(generator, outputs, batch)
        return _step(state, *losses, mesh, on_device)

    @torch.no_grad()
    def eval_step(self, state: trainer.TrainState, batch: RigSample,
                  generator: Optional[torch.Generator] = None, mesh=None,
                  on_device: bool = False) -> dict:
        """The losses on pred_flow, inference numerics; the embedding loss's
        samples from `generator` (a fresh one seeded 0 when None)."""
        generator = _default_generator(generator, batch.gt_flow.device)
        with active(mesh):
            outputs = self._forward(state.model, batch, batch.pred_flow, False)
            metrics = self._losses(generator, outputs, batch)[1]
        return _out(_summed(metrics, mesh), on_device)


class RigStage(_MotionStage):
    """JointNet or MaskNet training: the motion-embedding loss (x 0.1) plus,
    for `jointnet`, the chamfer between the shifted vertices and the GT
    joints and the L1 of the shift against the offsets to the nearest joint,
    and for `masknet` the attention BCE.  The jointnet knobs keep the JAX
    package's defaults, under which the loss is the reference's:
    `recall_weight` weights the joints-to-points direction of the chamfer,
    `dense_weight` > 0 upweights the L1 of vertices whose nearest joint has
    another within about `dense_sigma`, and `sep_weight` > 0 adds a hinge
    that keeps each shifted vertex `sep_alpha` of the way from its joint's
    nearest other joint."""

    def __init__(self, cfg: Config = DEFAULT_CONFIG, arch: str = "jointnet",
                 num_embed_sample: int = 512, width_scale: float = 1.0,
                 dense_weight: float = 0.0, dense_sigma: float = 0.07,
                 recall_weight: float = 1.0, sep_weight: float = 0.0, sep_alpha: float = 0.8):
        if arch not in ("jointnet", "masknet"):
            raise ValueError(f"arch must be jointnet or masknet, got {arch}")
        super().__init__(cfg, num_embed_sample)
        self.arch, self.width_scale = arch, width_scale
        self.dense_weight, self.dense_sigma = dense_weight, dense_sigma
        self.recall_weight = recall_weight
        self.sep_weight, self.sep_alpha = sep_weight, sep_alpha

    def init_state(self, seed: int = 0, device="cuda") -> trainer.TrainState:
        """A fresh JointNetMotion or MaskNetMotion (drawn from `seed`) on
        `device` (the card unless the caller asks for another)."""
        m = self.cfg.model
        cls = JointNetMotion if self.arch == "jointnet" else MaskNetMotion
        return self._state(cls(m.num_keyframes, m.motion_dim, m.aggr_method, self.width_scale,
                               generator=torch.Generator().manual_seed(seed)), device)

    def _forward(self, model, batch: RigSample, input_flow, train: bool):
        return model(input_flow, batch.mesh, train)

    def _crowding(self, batch: RigSample) -> torch.Tensor:
        """(B,V): for each vertex, the distance from its nearest GT joint to
        that joint's nearest other joint."""
        big = 1e6
        jm = batch.joints_mask
        d = torch.sqrt(torch.clamp(pairwise_sqdist(batch.joints, batch.joints), min=1e-12))
        d = torch.where(jm[:, None, :] & jm[:, :, None], d, torch.full_like(d, big))
        eye = torch.eye(d.shape[1], dtype=torch.bool, device=d.device)
        iso = torch.where(eye, torch.full_like(d, big), d).amin(-1)            # (B,J)
        dvj = pairwise_sqdist(batch.mesh.verts + batch.offsets, batch.joints)
        nearest = torch.where(jm[:, None, :], dvj, torch.full_like(dvj, big)).argmin(-1)
        return torch.gather(iso, 1, nearest)

    def _separation(self, y_pred, batch: RigSample) -> torch.Tensor:
        """The separation hinge relu(alpha |j1 - j2| - (|y - j2| - |y - j1|))
        per vertex, j1 its GT joint and j2 that joint's nearest other joint,
        averaged over the vertices that have one, then over the batch."""
        big = 1e6
        j1 = batch.mesh.verts + batch.offsets
        d = torch.sqrt(torch.clamp(pairwise_sqdist(j1, batch.joints), min=1e-12))
        d = torch.where(batch.joints_mask[:, None, :], d, torch.full_like(d, big))
        d = torch.where(d < 1e-4, torch.full_like(d, big), d)   # j1 itself
        spacing, j2_idx = d.min(-1)
        j2 = torch.gather(batch.joints, 1, j2_idx[..., None].expand(-1, -1, 3))
        d1 = torch.linalg.vector_norm(y_pred - j1, dim=-1)
        d2 = torch.linalg.vector_norm(y_pred - j2, dim=-1)
        ok = (batch.mesh.vert_mask & (spacing < big / 2)).float()
        h = torch.relu(self.sep_alpha * spacing - (d2 - d1))
        return batch_mean((h * ok).sum(-1) / torch.clamp(ok.sum(-1), min=1.0))

    def _losses(self, generator, outputs, batch: RigSample):
        motion_all, motion_aggr, pred = outputs
        loss_embed = self._embed_loss(generator, motion_all, motion_aggr, batch)
        vm = batch.mesh.vert_mask
        if self.arch == "masknet":
            loss_bce = bce_with_logits(pred[..., 0], batch.attn_mask, vm)
            total = 0.1 * loss_embed + loss_bce
            return total, dict(loss_bce=loss_bce, loss_motion=0.1 * loss_embed,
                               total_loss=total)
        disp = torch.tanh(pred)
        y_pred = disp + batch.mesh.verts
        if self.recall_weight != 1.0:
            m_prec, m_cov = chamfer_directional(y_pred, batch.joints, vm, batch.joints_mask)
            w = self.recall_weight
            loss_chamfer = batch_mean((m_prec + w * m_cov) / (1.0 + w))
        else:
            loss_chamfer = batched_chamfer_with_average(y_pred, batch.joints, vm,
                                                        batch.joints_mask)
        if self.dense_weight > 0.0:
            wts = 1.0 + self.dense_weight * torch.exp(-self._crowding(batch) / self.dense_sigma)
            loss_l1 = masked_l1_weighted(disp, batch.offsets, vm, wts)
        else:
            loss_l1 = masked_l1(disp, batch.offsets, vm)
        total = 0.1 * loss_embed + loss_chamfer + loss_l1
        metrics = dict(loss_chamfer=loss_chamfer, loss_l1=loss_l1, loss_motion=0.1 * loss_embed)
        if self.sep_weight > 0.0:
            loss_sep = self.sep_weight * self._separation(y_pred, batch)
            total = total + loss_sep
            metrics["loss_sep"] = loss_sep
        metrics["total_loss"] = total
        return total, metrics

    @torch.no_grad()
    def infer(self, state: trainer.TrainState, input_flow, mesh):
        """(motion_all, motion_aggr, prediction): for jointnet the shifted
        points are verts + tanh(prediction), for masknet the attention is
        sigmoid(prediction)."""
        return state.model(input_flow, mesh)


class SkinStage(_MotionStage):
    """SkinMotion training: the soft cross-entropy over the K nearest bones
    (slots without a bone and vertices whose labels do not sum to 1 left
    out) plus 0.01 x the motion-embedding loss."""

    def __init__(self, cfg: Config = DEFAULT_CONFIG, num_embed_sample: int = 512,
                 width_scale: float = 1.0):
        super().__init__(cfg, num_embed_sample)
        self.width_scale = width_scale

    def init_state(self, seed: int = 0, device="cuda") -> trainer.TrainState:
        """A fresh SkinMotion (drawn from `seed`) on `device` (the card unless
        the caller asks for another)."""
        m = self.cfg.model
        return self._state(SkinMotion(m.nearest_bone, m.use_Dg, m.use_Lf, m.num_keyframes,
                                      m.motion_dim, self.width_scale,
                                      generator=torch.Generator().manual_seed(seed)), device)

    def _forward(self, model, batch: RigSample, input_flow, train: bool):
        return model(batch.skin_input, input_flow, batch.mesh, train)

    def _losses(self, generator, outputs, batch: RigSample):
        motion_all, motion_aggr, logits = outputs
        loss_embed = self._embed_loss(generator, motion_all, motion_aggr, batch)
        K = logits.shape[-1]
        slots = batch.loss_mask[..., :K].to(logits.dtype)
        skin_gt = batch.skin_label[..., :K] * slots
        skin_gt = skin_gt / (skin_gt.abs().sum(-1, keepdim=True) + 1e-8)
        vert_ok = ((skin_gt.sum(-1) - 1.0).abs() < 1e-6) & batch.mesh.vert_mask
        w = slots * vert_ok[..., None].to(logits.dtype)
        per = cross_entropy_with_probs(logits, skin_gt)
        loss_skin = (per * w).sum() / torch.clamp(batch_sum(w.sum()), min=1.0)
        total = loss_skin + 0.01 * loss_embed
        return total, dict(loss_skin=loss_skin, loss_motion=0.01 * loss_embed, total_loss=total)

    @torch.no_grad()
    def infer(self, state: trainer.TrainState, skin_input, input_flow, mesh):
        """(motion_all, motion_aggr, logits over the K nearest bones)."""
        return state.model(skin_input, input_flow, mesh)


class _SkelStage:
    """What the bone and root stages share: the optimizer (lr 1e-3,
    milestone 50, gamma 0.1, the config's weight decay; not the config's
    lr), and the steps around each subclass's `_forward(model, batch,
    train, generator)` and `_losses(logits, batch)`."""

    net_cls: type

    def __init__(self, cfg: Config = DEFAULT_CONFIG):
        self.cfg = cfg

    def on_epoch(self, epoch: int):
        pass

    def make_tx(self, params, steps_per_epoch: int = 1) -> trainer.MultiStepAdam:
        return trainer.multistep_adam(params, 1e-3, (50,), 0.1, self.cfg.train.weight_decay,
                                      steps_per_epoch)

    def init_state(self, seed: int = 0, device="cuda") -> trainer.TrainState:
        """A fresh network (drawn from `seed`) on `device` (the card unless
        the caller asks for another), with its optimizer."""
        model = self.net_cls(generator=torch.Generator().manual_seed(seed)).to(device)
        return trainer.TrainState(model, self.make_tx(model.parameters()))

    def train_step(self, state: trainer.TrainState, batch: SkelSample,
                   generator: Optional[torch.Generator] = None, mesh=None,
                   on_device: bool = False) -> dict:
        """One optimizer step on `batch`, its random draws from `generator`
        (a fresh one seeded 0 on the batch's device when None)."""
        generator = _default_generator(generator, batch.joints.device)
        with active(mesh):
            losses = self._losses(self._forward(state.model, batch, True, generator), batch)
        return _step(state, *losses, mesh, on_device)

    @torch.no_grad()
    def eval_step(self, state: trainer.TrainState, batch: SkelSample,
                  mesh=None, on_device: bool = False) -> dict:
        with active(mesh):
            metrics = self._losses(self._forward(state.model, batch, False, None), batch)[1]
        return _out(_summed(metrics, mesh), on_device)

    @torch.no_grad()
    def infer(self, state: trainer.TrainState, batch: SkelSample) -> torch.Tensor:
        """The inference logits: (B,P,1) pair connectivity or (B,J,1) root."""
        return self._forward(state.model, batch, False, None)


class BoneStage(_SkelStage):
    """BoneNet training: the BCE of the pair logits against GT adjacency,
    with each pair's joints swapped with probability 1/2 and BoneNet's
    dropout, both drawn from the step's generator (swap first)."""

    net_cls = BoneNet

    def _forward(self, model, batch: SkelSample, train: bool, generator):
        return model(batch.mesh, batch.joints, batch.joints_mask, batch.pairs, batch.pair_attr,
                     train=train, permute=train, generator=generator)

    def _losses(self, logits, batch: SkelSample):
        loss = bce_with_logits(logits[..., 0], batch.pair_label, batch.pair_mask)
        return loss, dict(total_loss=loss)


class RootStage(_SkelStage):
    """RootNet training: softmax cross-entropy over the valid joints with
    the GT root as the class (padded joints at -1e30), and the share of
    samples whose argmax (first index on ties) is the root (`root_acc`)."""

    net_cls = RootNet

    def _forward(self, model, batch: SkelSample, train: bool, generator):
        return model(batch.mesh, batch.joints, batch.joints_mask, train=train)

    def _losses(self, logits, batch: SkelSample):
        z = torch.where(batch.joints_mask, logits[..., 0], torch.full_like(logits[..., 0], -1e30))
        picked = torch.gather(z, 1, batch.root_idx[:, None])[:, 0]
        loss = batch_mean(torch.logsumexp(z, -1) - picked)
        acc = batch_mean((z.argmax(-1) == batch.root_idx).float())
        return loss, dict(total_loss=loss, root_acc=acc)
