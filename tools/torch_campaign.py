"""Convergence campaign of morig_tpu_torch on the branching creature family —
counterpart of tools/campaign.py.

Trains the eight stages (corr -> deform, deform_seq -> joints, mask -> skin
-> bone, root) to convergence on procedurally rigged multi-limb creatures
(data/creature.py) with the epoch-scanned runner (train/scanned.py: each
step a CUDA-graph replay on the card), then runs the rig DAG and tracking
on held-out creatures and records the reference's metric set
(evaluate/eval_rigging.py:111-131, eval_tracking.py:230-235, the skin L1 of
train_skin.py's eval):

  python tools/torch_campaign.py --dir campaign_out                  # full run on the card
  python tools/torch_campaign.py --dir /tmp/smoke --smoke --device cpu

Flags, defaults and output layout are tools/campaign.py's, with `.pt`
checkpoints (train/checkpoint.py) and `--device` (default cuda; a CUDA
device that is not there is an error):
<dir>/<stage>/{metrics.jsonl, done.json, model_best.pt, checkpoint.pt},
<dir>/pred_flows.npz, <dir>/results/ (rig files, creature<seed>_tracking.npz,
campaign_timings.json: seconds and peak device memory per phase) and
<dir>/campaign_summary.json (its keys plus `device`: the card's name and
power limit).  The run resumes per stage: a stage with done.json is loaded
from its model_best.pt and not trained; a stage cut mid-way resumes from its
checkpoint at the epoch it reached, keeping the global best epoch of its
model_best sidecar.  Two joint-extraction configurations are evaluated:
"default" (the reference thresholds) and, when <dir>/joint_sweep_result.json
exists, "tuned" (its "best" thresholds, frozen from a validation sweep).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys
import time
import zipfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from morig_tpu_torch.utils.profiling import device_info, peak_gib, reset_peak  # noqa: E402

TRAIN_SEEDS = list(range(12))
VAL_SEEDS = [100, 101, 102]
TEST_SEEDS = [200, 201, 202, 203, 204]
# the pose and rig sets use keyframes 1-5 of 6 frames; tracking 10 of 11
POSE_FRAMES, TRACK_FRAMES = 6, 11


def stage_done(d: str) -> bool:
    return os.path.exists(os.path.join(d, "done.json"))


def mark_done(d: str, info: dict) -> None:
    with open(os.path.join(d, "done.json"), "w") as f:
        json.dump(info, f)


def chunk_epochs(steps_per_epoch: int) -> int:
    """Epochs per chunk: about 72 train steps, at most 25 epochs (JAX's rule,
    tools/campaign.py:113)."""
    return max(1, min(25, 72 // max(1, steps_per_epoch)))


# ---------------------------------------------------------------------------
# one stage
# ---------------------------------------------------------------------------

def train_stage(stage, name: str, out_dir: str, epochs: int, batcher, device, seed: int = 0,
                resume_state=None, chunk=None, patience=None, timings: dict | None = None):
    """Train one stage with best-on-val checkpointing (tools/campaign.py
    `train_stage`); returns its state with the best epoch's weights.

    With <out_dir>/<name>/done.json the stage's model_best.pt is loaded and
    nothing trains.  Otherwise training resumes from checkpoint.pt, else from
    model_best.pt (the first that reads), at its epoch and lowest val loss,
    with the global best epoch from model_best's sidecar (saved as epoch + 1).
    The state is `resume_state`, else `stage.init_state(seed)`; the schedules
    come from `default_rng(seed)` after one epoch's schedule is drawn (JAX's
    campaign draws its init sample from that stream first), the training
    draws from a generator seeded seed + 1 on the device.  The epochs run
    through `run_epochs_scanned` in chunks of `chunk` (`chunk_epochs` when
    None) with early stop after `patience` epochs without a better val loss.
    done.json holds the best epoch and the seconds; `timings[name]` gets those,
    the epochs run and the peak device memory."""
    from morig_tpu_torch.train import checkpoint as ckpt
    from morig_tpu_torch.train.scanned import run_epochs_scanned
    from morig_tpu_torch.train.trainer import MetricLogger

    dev = torch.device(device)
    reset_peak(dev)
    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    rng_np = np.random.default_rng(seed)
    batcher.schedule(0, rng_np)
    state = resume_state if resume_state is not None else stage.init_state(seed, device=dev)
    best_path = os.path.join(d, "model_best.pt")
    if stage_done(d):
        state, meta = ckpt.load_checkpoint(state, best_path)
        print(f"[campaign] {name}: loaded (best epoch {meta.get('epoch')})")
        return state
    start_epoch, init_lowest, init_best = 0, float("inf"), -1
    best_sidecar = best_path + ".json"
    if os.path.exists(best_sidecar):
        try:
            with open(best_sidecar) as f:
                init_best = int(json.load(f).get("epoch", 0)) - 1
        except (OSError, ValueError):
            pass
    for p in (os.path.join(d, "checkpoint.pt"), best_path):
        if not os.path.exists(p):
            continue
        try:
            state, meta = ckpt.load_checkpoint(state, p)
        except (OSError, RuntimeError, EOFError, pickle.UnpicklingError) as e:   # a torn write
            print(f"[campaign] {name}: {p} unreadable ({e}); falling back")
            continue
        start_epoch = int(meta.get("epoch", 0))
        init_lowest = float(meta.get("lowest_loss", float("inf")))
        print(f"[campaign] {name}: resuming at epoch {start_epoch} "
              f"(lowest val {init_lowest:.4f})")
        break
    t0 = time.time()
    logger = MetricLogger(d)
    stats: dict = {}
    try:
        state, best = run_epochs_scanned(
            stage, state, batcher, epochs=epochs, checkpoint_dir=d, logger=logger,
            generator=torch.Generator(device=dev).manual_seed(seed + 1), rng_np=rng_np,
            start_epoch=start_epoch, init_lowest=init_lowest, init_best_epoch=init_best,
            chunk_epochs=chunk or chunk_epochs(batcher.steps_per_epoch),
            early_stop_patience=patience, stats=stats)
    finally:
        logger.close()
    state, _ = ckpt.load_checkpoint(state, best_path)
    seconds = time.time() - t0
    mark_done(d, dict(best_epoch=best, seconds=seconds))
    ran = start_epoch + stats["steps"] // batcher.steps_per_epoch
    peak = peak_gib(dev)
    if timings is not None:
        timings[name] = dict(seconds=seconds, best_epoch=best, epochs_run=ran,
                             steps=stats["steps"], captures=stats["captures"], peak_gib=peak)
    print(f"[campaign] {name}: trained to epoch {ran} of {epochs} in {seconds:.1f} s "
          f"(best {best}; peak device memory "
          f"{'not measured' if peak is None else f'{peak:.2f} GiB'})")
    return state


# ---------------------------------------------------------------------------
# the rig stages' input flows and the held-out metrics
# ---------------------------------------------------------------------------

@torch.no_grad()
def pred_flow_for(deform, state, ds, device) -> list:
    """DeformNet's flow from frame 0 to each keyframe 1-5 per model of the
    pose dataset `ds`, the valid vertices' rows side by side: (V_real, 15)
    fp32 per model (tools/campaign.py `pred_flow_for`)."""
    flows = []
    for i in range(len(ds)):
        parts = []
        for t in range(1, POSE_FRAMES):
            b = ds.batch([i], 0, t, device=device)
            f = deform.infer(state, b)[0]
            vm = b.mesh.vert_mask[0].cpu().numpy()
            parts.append(f[0].float().cpu().numpy()[vm])
        flows.append(np.concatenate(parts, axis=1).astype(np.float32))
    return flows


FLOW_SPLITS = ("tr", "val", "te")


def load_flows(path: str, counts: dict):
    """The flows of pred_flows.npz by split ({split: [array per model]}), or
    None when it is missing or unreadable (a torn write: regenerate)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return {s: [z[f"{s}{i}"] for i in range(counts[s])] for s in FLOW_SPLITS}
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile) as e:   # a torn write
        print(f"[campaign] {path} unreadable ({e}); regenerating")
        return None


def save_flows(path: str, flows: dict) -> None:
    """pred_flows.npz written atomically (a temporary file, then a rename)."""
    tmp = path[:-4] + "_tmp.npz"          # np.savez appends .npz otherwise
    np.savez(tmp, **{f"{s}{i}": f for s in FLOW_SPLITS for i, f in enumerate(flows[s])})
    os.replace(tmp, path)


def feature_sizes(gt_pos: np.ndarray) -> np.ndarray:
    """Per GT joint, half the distance to its nearest other joint, clipped to
    [0.03, 0.10] (stand-in for the reference's per-model feature_size
    files, eval_rigging.py:111-121)."""
    dj = np.linalg.norm(gt_pos[:, None] - gt_pos[None], axis=-1)
    np.fill_diagonal(dj, np.inf)
    return np.clip(0.5 * dj.min(1), 0.03, 0.10)


def skin_l1_from_probs(probs: np.ndarray, batch_row: dict) -> float:
    """Skin L1 on the GT skeleton (train_skin.py's eval): the probabilities
    over the K nearest bones and the GT labels, each masked to the bones
    there are and renormalised, the L1 between them summed over K and
    averaged over the valid vertices.  `batch_row`: one model's loss_mask,
    skin_label and vert_mask as numpy."""
    K = probs.shape[-1]
    lm = batch_row["loss_mask"][:, :K]
    p = probs * lm
    p = p / np.maximum(p.sum(-1, keepdims=True), 1e-9)
    g = batch_row["skin_label"][:, :K] * lm
    g = g / np.maximum(g.sum(-1, keepdims=True), 1e-9)
    return float(np.abs(p - g).sum(-1)[batch_row["vert_mask"]].mean())


@torch.no_grad()
def skin_l1(skin, state, rig_ds, i: int, device) -> float:
    """`skin_l1_from_probs` of SkinMotion on model i of `rig_ds` (its
    pred_flow as input flow), the softmax in fp32."""
    b = rig_ds.batch([i], device=device)
    logits = skin.infer(state, b.skin_input, b.pred_flow, b.mesh)[2]
    probs = torch.softmax(logits[0].float(), -1).cpu().numpy()
    row = dict(loss_mask=b.loss_mask[0].cpu().numpy(), skin_label=b.skin_label[0].cpu().numpy(),
               vert_mask=b.mesh.vert_mask[0].cpu().numpy())
    return skin_l1_from_probs(probs, row)


def summarize(config: dict, per_model: list, skin_l1s: list, terrs: dict, knobs: dict,
              total_seconds: float, device: dict) -> dict:
    """campaign_summary.json: tools/campaign.py's keys (config, per_model,
    mean, loss_knobs, total_seconds) and the device."""
    def mean(k):
        return float(np.mean([m[k] for m in per_model]))

    return dict(
        config=config,
        per_model=per_model,
        mean=dict(
            joint_IoU=mean("joint_IoU"), joint_precision=mean("joint_precision"),
            joint_recall=mean("joint_recall"), chamfer_j2j=mean("chamfer_j2j"),
            skin_l1=float(np.mean(skin_l1s)),
            tracking_full_flow_error=terrs["seq"]["full_flow_error"],
            tracking_vis_flow_error=terrs["seq"].get("vis_flow_error"),
            tracking_full_flow_error_discrete=terrs["discrete"]["full_flow_error"],
            tracking_vis_flow_error_discrete=terrs["discrete"].get("vis_flow_error"),
        ),
        loss_knobs=knobs,
        total_seconds=total_seconds,
        device=device,
    )


# ---------------------------------------------------------------------------
# the campaign
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default="campaign_out")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--epochs-scale", type=float, default=1.0)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--train-creatures", type=int, default=len(TRAIN_SEEDS))
    # the jointnet loss knobs (RigStage): 0 / 1 is the reference's loss
    # (train_rig.py:176-183); campaign v4 ran 3.0 / 2.0
    ap.add_argument("--dense-weight", type=float, default=0.0)
    ap.add_argument("--recall-weight", type=float, default=1.0)
    ap.add_argument("--sep-weight", type=float, default=0.0)
    ap.add_argument("--sep-alpha", type=float, default=0.8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, the card; 'cpu' runs the kernels' "
                         "plain versions)")
    return ap


def sizes(args) -> dict:
    """Seeds, sizes, epochs and patience of a run (tools/campaign.py:193-226)."""
    if args.smoke:
        E = dict(corr=3, deform=3, deform_seq=3, rig=3, skin=3, skel=3)
        return dict(train=[0, 1], val=[100], test=[200], n_pts=256, tv=700, E=E,
                    P=dict.fromkeys(E, None), bs=2, seq_frames=5)
    s = args.epochs_scale
    return dict(train=list(range(args.train_creatures)), val=VAL_SEEDS, test=TEST_SEEDS,
                n_pts=1024, tv=1900,
                E=dict(corr=int(200 * s), deform=int(220 * s), deform_seq=int(150 * s),
                       rig=int(420 * s), skin=int(300 * s), skel=int(240 * s)),
                P=dict(corr=80, deform=60, deform_seq=60, rig=120, skin=120, skel=120),
                bs=args.batch_size, seq_frames=11)


def main(argv=None) -> dict:
    from morig_tpu_torch.cli import _device
    from morig_tpu_torch.data.creature import (creature_pose_dataset, creature_rig_dataset,
                                               creature_skel_dataset)
    from morig_tpu_torch.train.scanned import (const_scan_batcher, pose_scan_batcher,
                                               rig_scan_batcher, with_val_dataset)
    from morig_tpu_torch.train.stages import (BoneStage, CorrPoseStage, DeformPoseStage,
                                              RigStage, RootStage, SkinStage)

    args = build_parser().parse_args(argv)
    dev = _device(args)
    os.makedirs(args.dir, exist_ok=True)
    z = sizes(args)
    train_seeds, val_seeds, test_seeds = z["train"], z["val"], z["test"]
    n_pts, tv, E, P, bs = z["n_pts"], z["tv"], z["E"], z["P"], z["bs"]
    info = device_info(dev)
    timings: dict = dict(device=info, stages={})
    print(f"[campaign] device {info['name']} (power limit {info['power_limit']})")
    t_all = time.time()

    # ---- datasets ---------------------------------------------------------
    def pose_ds(seeds, frames):
        return creature_pose_dataset(num_models=len(seeds), seed=seeds[0], num_frames=frames,
                                     num_points=n_pts, target_verts=tv)

    t0 = time.time()
    pose_tr, pose_val, pose_te = (pose_ds(s, POSE_FRAMES)
                                  for s in (train_seeds, val_seeds, test_seeds))
    timings["pose_datasets_s"] = time.time() - t0
    print(f"[campaign] pose datasets: {len(pose_tr)}/{len(pose_val)}/{len(pose_te)} "
          f"buckets {sorted(set(pose_tr.bucket_of))} ({timings['pose_datasets_s']:.1f} s)")

    def pose_batcher(tr, val, sequential):
        return with_val_dataset(
            pose_scan_batcher(tr, bs, "modelsresource", sequential, device=dev),
            pose_scan_batcher(val, bs, "modelsresource", sequential, device=dev))

    def run_stage(stage_obj, name, epochs, batcher, patience, **kw):
        return train_stage(stage_obj, name, args.dir, epochs, batcher, dev, patience=patience,
                           timings=timings["stages"], **kw)

    # ---- stage 1: CorrNet -------------------------------------------------
    corr = CorrPoseStage()
    corr.train_vismask = True
    corr.vis_branch_start_epoch = 0       # the branch on from the start
    pose_b = pose_batcher(pose_tr, pose_val, False)
    corr_state = run_stage(corr, "corr", E["corr"], pose_b, P["corr"])

    # ---- stage 2: DeformNet, the extractor from corr, frozen ---------------
    deform = DeformPoseStage()
    deform_state0 = deform.init_extractor_from(deform.init_state(0, device=dev), corr_state)
    deform_was_done = stage_done(os.path.join(args.dir, "deform"))
    deform_state = run_stage(deform, "deform", E["deform"], pose_b, P["deform"],
                         resume_state=deform_state0)
    flows_path = os.path.join(args.dir, "pred_flows.npz")
    if not deform_was_done and os.path.exists(flows_path):
        os.remove(flows_path)             # deform trained in this run: the dump is stale

    # ---- stage 2b: the sequential DeformNet (the tracking model) ----------
    # trained on contiguous frame pairs (SeqModelsResourcesDataset,
    # dataset_pose.py:101-140); its checkpoint drives tracking
    # (eval_tracking.py:21)
    t0 = time.time()
    pose_seq_tr, pose_seq_val = (pose_ds(s, z["seq_frames"]) for s in (train_seeds, val_seeds))
    timings["seq_datasets_s"] = time.time() - t0
    deform_seq = DeformPoseStage()
    dseq0 = deform_seq.init_extractor_from(deform_seq.init_state(0, device=dev), corr_state)
    deform_seq_state = run_stage(deform_seq, "deform_seq", E["deform_seq"],
                             pose_batcher(pose_seq_tr, pose_seq_val, True), P["deform_seq"],
                             resume_state=dseq0)

    # ---- the rig stages' input flows (README.md:84-85 handoff) -------------
    counts = dict(tr=len(train_seeds), val=len(val_seeds), te=len(test_seeds))
    flows = load_flows(flows_path, counts)
    if flows is None:
        t0 = time.time()
        flows = {s: pred_flow_for(deform, deform_state, ds, dev)
                 for s, ds in zip(FLOW_SPLITS, (pose_tr, pose_val, pose_te))}
        save_flows(flows_path, flows)
        timings["pred_flows_s"] = time.time() - t0
        print(f"[campaign] pred_flow dumps in {timings['pred_flows_s']:.1f} s")

    t0 = time.time()
    rig_tr, rig_val, rig_te = (
        creature_rig_dataset(num_models=len(seeds), seed=seeds[0], num_points=n_pts,
                             target_verts=tv, pred_flows=flows[s], device=dev)
        for s, seeds in zip(FLOW_SPLITS, (train_seeds, val_seeds, test_seeds)))
    timings["rig_datasets_s"] = time.time() - t0

    # ---- stages 3-4: joints and mask --------------------------------------
    nes = min(512, rig_tr.pad_verts)
    joint = RigStage(arch="jointnet", num_embed_sample=nes, dense_weight=args.dense_weight,
                     recall_weight=args.recall_weight, sep_weight=args.sep_weight,
                     sep_alpha=args.sep_alpha)
    mask = RigStage(arch="masknet", num_embed_sample=nes)
    rig_b = rig_scan_batcher(rig_tr, bs, val_ds=rig_val, device=dev)
    joint_state = run_stage(joint, "joints", E["rig"], rig_b, P["rig"])
    mask_state = run_stage(mask, "mask", E["rig"], rig_b, P["rig"])

    # ---- stage 5: skin ----------------------------------------------------
    skin = SkinStage(num_embed_sample=nes)
    skin_state = run_stage(skin, "skin", E["skin"], rig_b, P["skin"])

    # ---- stage 6: bone and root (GT and jittered joint sets) ---------------
    t0 = time.time()
    skel_tr = creature_skel_dataset(num_models=len(train_seeds), seed=train_seeds[0],
                                    target_verts=tv, device=dev)
    skel_val = creature_skel_dataset(num_models=len(val_seeds), seed=val_seeds[0],
                                     target_verts=tv, extra_per_model=1, device=dev)
    timings["skel_datasets_s"] = time.time() - t0
    skel_b = const_scan_batcher(skel_tr, skel_val)
    bone, root = BoneStage(), RootStage()
    bone_state = run_stage(bone, "bone", E["skel"], skel_b, P["skel"])
    root_state = run_stage(root, "root", E["skel"], skel_b, P["skel"])

    per_model, skin_l1s, terrs = heldout(
        args.dir, dev, test_seeds, tv, n_pts, pose_te, rig_te,
        dict(deform=deform_state, deform_seq=deform_seq_state, joint=joint_state,
             mask=mask_state, root=root_state, bone=bone_state, skin=skin_state),
        skin, timings)
    timings["total_s"] = time.time() - t_all
    summary = summarize(
        dict(train=len(train_seeds), val=len(val_seeds), test=len(test_seeds), epochs=E,
             batch_size=bs, target_verts=tv, smoke=args.smoke),
        per_model, skin_l1s, terrs,
        dict(dense_weight=args.dense_weight, recall_weight=args.recall_weight),
        timings["total_s"], info)
    with open(os.path.join(args.dir, "campaign_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    with open(os.path.join(args.dir, "results", "campaign_timings.json"), "w") as f:
        json.dump(timings, f, indent=2)
    print("[campaign] SUMMARY:", json.dumps(summary["mean"], indent=2))
    return summary


def heldout(out_dir: str, dev, test_seeds, tv: int, n_pts: int, pose_te, rig_te, states: dict,
            skin, timings: dict) -> tuple:
    """The held-out evaluation (tools/campaign.py:409-566): rigs of the
    test creatures under each joint configuration, with voxels and surface
    geodesics of the regenerated creatures; skin L1 on the GT skeleton;
    tracking of the first test creature with the sequential and the
    discrete DeformNet.  Returns (the headline configuration's per-model
    joint metrics, the skin L1 per model, the flow errors of each
    tracking); `timings["heldout"]` gets the seconds of each part."""
    from morig_tpu_torch.core import batch as B
    from morig_tpu_torch.core.config import DEFAULT_CONFIG
    from morig_tpu_torch.data.creature import make_creature, make_creature_sequence
    from morig_tpu_torch.eval.metrics import flow_errors, joint_match_metrics
    from morig_tpu_torch.geometry import skeleton as sk
    from morig_tpu_torch.geometry.geodesic import surface_geodesic
    from morig_tpu_torch.geometry.voxel import voxelize_mesh
    from morig_tpu_torch.pipelines.rig_predict import RigPredictor
    from morig_tpu_torch.pipelines.tracking import Tracker, make_scanned_tracker

    # "default": the reference thresholds (eval_rigging.py:80-95); "tuned":
    # a validation-creature sweep (tools/sweep_joint_params.py), frozen,
    # never tuned on the test seeds
    cfgs = {"default": DEFAULT_CONFIG}
    sweep_path = os.path.join(out_dir, "joint_sweep_result.json")
    if os.path.exists(sweep_path):
        with open(sweep_path) as f:
            tuned = json.load(f)["best"]
        cfgs["tuned"] = dataclasses.replace(
            DEFAULT_CONFIG, joints=dataclasses.replace(DEFAULT_CONFIG.joints, **tuned))
        print(f"[campaign] joint extraction thresholds from sweep: {tuned}")

    res_dir = os.path.join(out_dir, "results")
    os.makedirs(res_dir, exist_ok=True)
    entries = [rig_te._mesh_cache[i] for i in range(len(test_seeds))]
    pts_list = [np.stack([pose_te.models[i].pts_traj[:, t, :] for t in range(1, POSE_FRAMES)])
                for i in range(len(test_seeds))]
    # voxels and surface geodesics from the creatures' faces (regenerated,
    # deterministic by seed): the volumetric skin distances
    voxes, surf_geos, h = [], [], dict(voxelize_s=[], surface_geodesic_s=[])
    for s_ in test_seeds:
        c = make_creature(s_, target_verts=tv)
        t0 = time.time()
        voxes.append(voxelize_mesh(c.verts, c.faces))
        h["voxelize_s"].append(time.time() - t0)
        t0 = time.time()
        surf_geos.append(surface_geodesic(c.verts, c.faces))
        h["surface_geodesic_s"].append(time.time() - t0)
    print(f"[campaign] held-out voxels {sum(h['voxelize_s']):.1f} s, surface geodesics "
          f"{sum(h['surface_geodesic_s']):.1f} s ({len(test_seeds)} creatures)")

    nets = [states[n].model for n in ("deform", "joint", "mask", "root", "bone", "skin")]
    per_model_by_cfg, h["predict_rig_batch_s"], h["predict_rig_batch_peak_gib"] = {}, {}, {}
    for cfg_name, pred_cfg in cfgs.items():
        predictor = RigPredictor(*nets, cfg=pred_cfg)
        reset_peak(dev)
        t0 = time.time()
        rigs = predictor.predict_rig_batch(entries, pts_list, voxes=voxes, surf_geos=surf_geos)
        h["predict_rig_batch_s"][cfg_name] = time.time() - t0
        h["predict_rig_batch_peak_gib"][cfg_name] = peak_gib(dev)
        pm = []
        for i, s_ in enumerate(test_seeds):
            gt, pred = rig_te.models[i].rig, rigs[i]
            jm = joint_match_metrics(pred.pos, gt.pos, feature_sizes(gt.pos))
            if cfg_name != "default" or "tuned" not in cfgs:    # the headline's artefacts
                pred.save(os.path.join(res_dir, f"creature{s_}_rig.txt"))
                sk.Rig(names=list(gt.names), pos=gt.pos, parents=gt.parents,
                       skins=gt.skins).save(os.path.join(res_dir, f"creature{s_}_gt_rig.txt"))
            pm.append(dict(seed=s_, num_pred_joints=int(pred.num_joints),
                           num_gt_joints=int(gt.num_joints), **jm))
            print(f"[campaign] [{cfg_name}] creature{s_}: J_pred={pred.num_joints} "
                  f"J_gt={gt.num_joints} IoU={jm['joint_IoU']:.3f} "
                  f"P={jm['joint_precision']:.3f} R={jm['joint_recall']:.3f} "
                  f"CD={jm['chamfer_j2j']:.4f}")
        per_model_by_cfg[cfg_name] = pm
        print(f"[campaign] [{cfg_name}] rigs of {len(test_seeds)} held-out creatures in "
              f"{h['predict_rig_batch_s'][cfg_name]:.1f} s")
    per_model = per_model_by_cfg.get("tuned", per_model_by_cfg["default"])

    t0 = time.time()
    skin_l1s = [skin_l1(skin, states["skin"], rig_te, i, dev) for i in range(len(test_seeds))]
    h["skin_eval_s"] = time.time() - t0

    # tracking of the first held-out creature with its GT rig, by the
    # sequential DeformNet (eval_tracking.py:21) and, as an ablation on the
    # same data, by the discrete-keyframe one
    seq = make_creature_sequence(seed=test_seeds[0], num_frames=TRACK_FRAMES,
                                 num_points=min(n_pts, 512), target_verts=tv)
    c = seq["rig"]
    gt_rig = sk.Rig(names=list(c.names), pos=c.joints.astype(np.float64), parents=c.parents,
                    skins=c.skins)
    entry = B.build_mesh(c.verts, seq["tpl_edges"], seq["geo_edges"],
                         B.bucket_size(len(c.verts), (1024, 2048, 4096)))
    terrs, h["tracking"] = {}, {}
    for ab_name, key in (("seq", "deform_seq"), ("discrete", "deform")):
        run_tracker = make_scanned_tracker(Tracker(states[key].model, gt_rig, entry))
        reset_peak(dev)
        t0 = time.time()
        traj, vis, quats = run_tracker(c.verts, seq["pts_traj"])
        dt = time.time() - t0
        frames = TRACK_FRAMES - 1
        h["tracking"][ab_name] = dict(seconds=dt, frames=frames, frames_per_s=frames / dt,
                                      peak_gib=peak_gib(dev))
        terrs[ab_name] = flow_errors(traj, seq["vtx_traj"][:, 1:, :], seq["vismask"][:, 1:])
        if ab_name == "seq":
            np.savez(os.path.join(res_dir, f"creature{test_seeds[0]}_tracking.npz"),
                     pred_vtx_traj=traj, pred_vismask=vis, pred_quats=quats)
        print(f"[campaign] tracking[{ab_name}]: {terrs[ab_name]} ({dt:.1f} s, "
              f"{frames / dt:.3f} tracked frames/s)")
    timings["heldout"] = h
    return per_model, skin_l1s, terrs


if __name__ == "__main__":
    main()
