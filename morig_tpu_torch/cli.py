"""Command-line workflow of the port — counterpart of morig_tpu/cli.py, with
its subcommands, flags, defaults and outputs, on PyTorch and the port's
CUDA kernels (the card unless `--device cpu`):

  python -m morig_tpu_torch.cli train corr_pose   --data capsule --epochs 3
  python -m morig_tpu_torch.cli train deform_pose --data /path/to/train --init-extractor ckpt/model_best.pt
  python -m morig_tpu_torch.cli train joints|mask|skin|bone|root ...
  python -m morig_tpu_torch.cli eval corr|deform|attn --resume ckpt/model_best.pt
  python -m morig_tpu_torch.cli eval rig|tracking --res results/ --gt data/
  python -m morig_tpu_torch.cli predict-rig --out results/
  python -m morig_tpu_torch.cli track --out results/

`--data capsule` and `creature` are the synthetic fixtures; anything else is
a dataset folder in the reference's layout (data/loaders.py).  The epoch
schedules draw from np.random.default_rng(--seed) exactly as the JAX CLI
does, so both train on the same batches in the same order.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from morig_tpu_torch.train import checkpoint as ckpt
from morig_tpu_torch.train.trainer import MetricLogger, run_epochs

NOT_CARRIED_OVER = """\
Flags of the JAX CLI that are not defined here (argparse rejects them):
--platform (use --device), --edge-bwd and --knn-impl (the port has one
implementation of each: its CUDA kernels, their plain versions on the
CPU), --edge-impl outside `train` and its values auto and xla,
--scan-epochs (train/scanned.py fuses epochs to cut dispatch round trips
to a TPU; not ported), and the `bench` subcommand (it runs the
repository's JAX bench.py).  Networks are initialized from
the port's own seeded generator (--seed), not from JAX's: the same seed
gives other initial weights than the JAX CLI."""


def _add_common(p):
    p.add_argument("--data", default="capsule",
                   help="'capsule', 'creature' (branching synthetic family), "
                        "or a dataset folder in the reference layout")
    p.add_argument("--kind", default="modelsresource",
                   choices=["modelsresource", "deformingthings"])
    p.add_argument("--sequential", action="store_true")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--checkpoint", default="checkpoints/run")
    p.add_argument("--logdir", default="logs/run")
    p.add_argument("--resume", default="",
                   help="a checkpoint of this CLI (.pt); eval also takes a "
                        "JAX CLI checkpoint (.msgpack)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-models", type=int, default=2, help="capsule fixture size")
    p.add_argument("--fixture-points", type=int, default=None,
                   help="capsule fixture point-cloud size (default 1024)")
    p.add_argument("--fixture-lat", type=int, default=None,
                   help="capsule fixture latitude rings (default 17)")
    p.add_argument("--fixture-lon", type=int, default=None,
                   help="capsule fixture longitude segments (default 16)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda, the card; 'cpu' runs the "
                        "kernels' plain versions)")


def _device(args) -> torch.device:
    """The device to run on; a CUDA device that is not there is an error,
    never a silent fall back to the CPU."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    return dev


def _fixture_kw(args):
    kw = {}
    if args.fixture_points:
        kw["num_points"] = args.fixture_points
    if args.fixture_lat:
        kw["n_lat"] = args.fixture_lat
    if args.fixture_lon:
        kw["n_lon"] = args.fixture_lon
    return kw


def _pose_dataset(args, shape: bool = False):
    from morig_tpu_torch.data.pose import PoseDataset, capsule_pose_dataset

    nf = 2 if shape else 6
    if args.data == "capsule":
        return capsule_pose_dataset(num_models=args.num_models, num_frames=nf,
                                    **_fixture_kw(args))
    if args.data == "creature":
        from morig_tpu_torch.data.creature import creature_pose_dataset

        return creature_pose_dataset(num_models=args.num_models, seed=args.seed, num_frames=nf)
    from morig_tpu_torch.data import loaders

    if shape:
        return PoseDataset(loaders.load_shape_models(args.data))
    return PoseDataset(loaders.load_pose_models(args.data, args.kind, args.sequential))


def _rig_dataset(args):
    from morig_tpu_torch.data.rig import RigDataset, capsule_rig_dataset

    if args.data == "capsule":
        return capsule_rig_dataset(num_models=args.num_models, **_fixture_kw(args))
    if args.data == "creature":
        from morig_tpu_torch.data.creature import creature_rig_dataset

        return creature_rig_dataset(num_models=args.num_models, seed=args.seed)
    from morig_tpu_torch.data.loaders import load_rig_models

    return RigDataset(load_rig_models(args.data))


def load_weights(state, path: str):
    """Load a checkpoint into `state`: one of this CLI (.pt: model, optimizer,
    schedule and step), or a JAX CLI's flax checkpoint (.msgpack: the
    network's parameters and statistics only).  Returns the state."""
    if path.endswith(".msgpack"):
        from morig_tpu_torch.weights import flax_to_state_dict

        tree = ckpt.load_flax_checkpoint(path)
        state.model.load_state_dict(flax_to_state_dict(tree["params"], tree["batch_stats"]),
                                    strict=True)
        return state
    return ckpt.load_checkpoint(state, path)[0]


def _train_loop(stage, args, batch_fn, default_epochs: int, state=None):
    dev = _device(args)
    rng_np = np.random.default_rng(args.seed)
    # the JAX CLI draws one training epoch here (its init sample); drawing it
    # too keeps every later schedule equal to the JAX CLI's
    next(batch_fn(rng_np))
    if state is None:
        state = stage.init_state(args.seed, dev)
    start_epoch = 0
    if args.resume:
        state, meta = ckpt.load_checkpoint(state, args.resume)
        start_epoch = int(meta.get("epoch", 0))
    logger = MetricLogger(args.logdir)
    state, best = run_epochs(
        stage, state,
        train_batches=lambda e: batch_fn(rng_np),
        val_batches=lambda: batch_fn(rng_np, train=False),
        test_batches=None,
        epochs=args.epochs or default_epochs, checkpoint_dir=args.checkpoint, logger=logger,
        generator=torch.Generator(device=dev).manual_seed(args.seed + 1),
        start_epoch=start_epoch,
    )
    logger.close()
    print(f"best epoch: {best}; checkpoints in {args.checkpoint}")
    return state


EDGE_TILE = 128      # --edge-impl windowed: the windowed kernel's vertex tile


def cmd_train(args):
    from morig_tpu_torch.train import stages as S

    dev = _device(args)
    name = args.stage
    tile = EDGE_TILE if args.edge_impl == "windowed" else None
    if name in ("corr_pose", "corr_shape", "deform_pose", "deform_shape"):
        ds = _pose_dataset(args, shape=name.endswith("_shape"))
        ds.edge_tile = tile

        def batches(rng, train=True):
            return ds.epoch_batches(rng, args.batch_size, args.kind, args.sequential, train,
                                    device=dev)

        if name.startswith("corr"):
            stage = S.CorrPoseStage()
            if args.train_vismask:
                stage.train_vismask = True
            _train_loop(stage, args, batches, 300)
            return
        stage = S.DeformPoseStage(train_extractor=args.train_extractor)
        state = None
        if args.init_extractor:
            state = stage.init_state(args.seed, dev)
            corr_state = load_weights(S.CorrPoseStage().init_state(0, dev), args.init_extractor)
            state = stage.init_extractor_from(state, corr_state)
        _train_loop(stage, args, batches, 150, state=state)
    elif name in ("joints", "mask", "skin"):
        ds = _rig_dataset(args)
        ds.edge_tile = tile
        n_embed = min(512, ds.pad_verts)
        stage = S.SkinStage(num_embed_sample=n_embed) if name == "skin" else S.RigStage(
            arch="jointnet" if name == "joints" else "masknet", num_embed_sample=n_embed)

        def batches(rng, train=True):
            return ds.epoch_batches(rng, args.batch_size, train, device=dev)

        _train_loop(stage, args, batches, 120)
    else:                                                   # bone, root
        from morig_tpu_torch.data.skeleton_data import build_skel_sample, capsule_skel_dataset

        if args.data == "creature":
            from morig_tpu_torch.data.creature import creature_skel_dataset

            sample = creature_skel_dataset(num_models=args.num_models, seed=args.seed,
                                           device=dev, edge_tile=tile)
        elif args.data != "capsule":
            rig_ds = _rig_dataset(args)
            sample = build_skel_sample(rig_ds._mesh_cache, [m.rig.pos for m in rig_ds.models],
                                       [m.rig for m in rig_ds.models], device=dev,
                                       edge_tile=tile)
        else:
            sample = capsule_skel_dataset(num_models=args.num_models, max_joints=16, device=dev,
                                          edge_tile=tile)
        stage = S.BoneStage() if name == "bone" else S.RootStage()

        def batches(rng, train=True):
            yield sample

        _train_loop(stage, args, batches, 80)


def cmd_eval(args):
    """Offline metrics: correspondence accuracy against tolerance, mean flow
    L2, attention precision-recall, and the results-folder workflows
    `eval rig` / `eval tracking`."""
    dev = _device(args)
    if args.what in ("rig", "tracking"):
        from morig_tpu_torch.eval.folder_eval import eval_rig_folder, eval_tracking_folder

        if not args.res or not args.gt:
            raise SystemExit("eval rig/tracking needs --res and --gt folders")
        if args.what == "rig":
            eval_rig_folder(args.res, args.gt, device=dev)
        else:
            eval_tracking_folder(args.res, args.gt)
        return
    from morig_tpu_torch.data.pose import eval_frame_pair
    from morig_tpu_torch.eval import metrics as M
    from morig_tpu_torch.train import stages as S

    def state_of(stage):
        state = stage.init_state(0, dev)
        return load_weights(state, args.resume) if args.resume else state

    def np_(x):
        return x.detach().cpu().numpy()

    if args.what == "attn":
        rig_ds = _rig_dataset(args)
        stage = S.RigStage(arch="masknet", num_embed_sample=min(512, rig_ds.pad_verts))
        batch = rig_ds.batch(list(range(min(len(rig_ds), args.batch_size))), device=dev)
        _, _, logits = stage.infer(state_of(stage), batch.pred_flow, batch.mesh)
        vm = np_(batch.mesh.vert_mask[0])
        for t, p, r in M.attention_pr_curve(np_(logits[0, :, 0])[vm], np_(batch.attn_mask[0])[vm]):
            print(f"threshold {t:.2f}: precision {p:.3f} recall {r:.3f}")
        return
    ds = _pose_dataset(args)
    src_f, tar_f = eval_frame_pair(args.sequential)
    nf = min(m.num_frames for m in ds.models)
    src_f, tar_f = min(src_f, nf - 2), min(tar_f, nf - 1)
    batch = ds.batch(list(range(min(len(ds), args.batch_size))), src_f, tar_f, device=dev)
    if args.what == "corr":
        stage = S.CorrPoseStage()
        vtx_f, pts_f, _, _ = stage.infer(state_of(stage), batch)
        vm = np_(batch.mesh.vert_mask[0])
        corr = np_(batch.corr.v2p[0])[np_(batch.corr.v2p_mask[0])]
        curve = M.corr_accuracy_curve(np_(vtx_f[0])[vm], np_(pts_f[0]), corr,
                                      np_(batch.points.pts[0]))
        for tol, acc in curve.items():
            print(f"tolerance {tol:.2f}: accuracy {acc:.4f}")
    else:                                                   # deform
        stage = S.DeformPoseStage()
        flow, *_ = stage.infer(state_of(stage), batch)
        vm = np_(batch.mesh.vert_mask)
        err = M.mean_flow_l2(np_(flow)[vm], np_(batch.gt_flow)[vm])
        print(f"mean flow L2: {err:.5f}  (reference runs: 0.06631 / 0.06352, eval_deform.py:4-5)")


def cmd_predict_rig(args):
    from morig_tpu_torch.data.mesh_io import write_ply_points
    from morig_tpu_torch.geometry import skeleton as sk
    from morig_tpu_torch.pipelines.rig_predict import capsule_predictor

    dev = _device(args)
    os.makedirs(args.out, exist_ok=True)
    predictor, pose_ds, rig_ds = capsule_predictor(train_steps=args.train_steps, device=dev)
    for i, m in enumerate(pose_ds.models):
        out = os.path.join(args.out, f"{m.name}_rig.txt")
        if os.path.exists(out) and not args.force:
            # resumable: a model whose artifact exists is skipped
            print(f"{m.name}: exists, skipped ({out})")
            continue
        pts_frames = np.stack([m.pts_traj[:, t, :] for t in range(1, 6)])
        inter = {} if args.save_intermediates else None
        rig = predictor.predict_rig(rig_ds._mesh_cache[i], pts_frames, intermediates=inter)
        rig.save(out)
        if args.save_intermediates:
            # the artifacts `eval rig --res` reads: the stage byproducts
            # predict_rig kept, not recomputed
            write_ply_points(os.path.join(args.out, f"{m.name}_shift.ply"), inter["shifted"])
            np.save(os.path.join(args.out, f"{m.name}_attn.npy"), inter["attn"])
            gt = rig_ds.models[i].rig
            sk.Rig(names=list(gt.names), pos=gt.pos, parents=gt.parents, skins=gt.skins).save(
                os.path.join(args.out, f"{m.name}_gt_rig.txt"))
        print(f"{m.name}: {rig.num_joints} joints -> {out}")


def cmd_track(args):
    from morig_tpu_torch.core.batch import build_mesh
    from morig_tpu_torch.data.synthetic import make_capsule_sequence
    from morig_tpu_torch.eval.metrics import flow_errors
    from morig_tpu_torch.geometry import skeleton as sk
    from morig_tpu_torch.pipelines.tracking import Tracker
    from morig_tpu_torch.train.stages import DeformPoseStage

    dev = _device(args)
    os.makedirs(args.out, exist_ok=True)
    seq = make_capsule_sequence(num_frames=args.frames, num_points=256)
    cap = seq["rig"]
    rig = sk.Rig(names=list(cap.names), pos=cap.joints.astype(float), parents=cap.parents,
                 skins=cap.skins)
    entry = build_mesh(cap.verts, seq["tpl_edges"], seq["geo_edges"], 1024)
    tracker = Tracker(DeformPoseStage().init_state(0, dev).model, rig, entry)
    traj, vis, quats = tracker.run(cap.verts, seq["pts_traj"])
    errs = flow_errors(traj, seq["vtx_traj"][:, 1:, :], seq["vismask"][:, 1:])
    extra = {}
    if args.smooth_passes > 0:
        # temporally smoothed joint rotations, re-posed, and overlay PLYs
        from morig_tpu_torch.eval.visualize import export_tracking, smooth_tracking_quats

        straj, squats = smooth_tracking_quats(rig, cap.verts, quats, num_pass=args.smooth_passes,
                                              device=dev)
        extra = dict(pred_vtx_traj_smooth=straj, pred_quats_smooth=squats)
        export_tracking(args.out, "capsule_smooth", straj, seq["pts_traj"][:, 1:, :])
    np.savez(os.path.join(args.out, "capsule_tracking.npz"), pred_vtx_traj=traj,
             pred_vismask=vis, pred_quats=quats, **extra, **errs)
    print(errs)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="morig_tpu_torch", epilog=NOT_CARRIED_OVER,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a pipeline stage", epilog=NOT_CARRIED_OVER,
                       formatter_class=argparse.RawDescriptionHelpFormatter)
    t.add_argument("stage", choices=["corr_pose", "corr_shape", "deform_pose", "deform_shape",
                                     "joints", "mask", "skin", "bone", "root"])
    _add_common(t)
    t.add_argument("--train-vismask", action="store_true")
    t.add_argument("--train-extractor", action="store_true")
    t.add_argument("--init-extractor", default="",
                   help="corr checkpoint (.pt, or a JAX CLI .msgpack) to initialize "
                        "the deform extractor")
    t.add_argument("--edge-impl", default="fused", choices=["fused", "windowed"],
                   help="the edge layers' forward in training: 'fused', the "
                        "full-table kernel K1; 'windowed', the windowed kernel K5 at "
                        f"a {EDGE_TILE}-vertex tile on every batch whose tables are "
                        "local at it (a batch whose tables are not local trains on "
                        "K1); the backward is K6 either way")
    t.set_defaults(fn=cmd_train)

    ev = sub.add_parser("eval", help="offline metrics (corr/deform/attn) and "
                                     "results-folder eval (rig/tracking)")
    ev.add_argument("what", choices=["corr", "deform", "attn", "rig", "tracking"])
    _add_common(ev)
    ev.add_argument("--res", default="", help="results folder (eval rig/tracking)")
    ev.add_argument("--gt", default="", help="ground-truth folder (eval rig/tracking)")
    ev.set_defaults(fn=cmd_eval)

    p = sub.add_parser("predict-rig", help="full rig prediction demo")
    _add_common(p)
    p.add_argument("--out", default="results")
    p.add_argument("--train-steps", type=int, default=10)
    p.add_argument("--save-intermediates", action="store_true",
                   help="also dump {name}_shift.ply/_attn.npy/_gt_rig.txt "
                        "(the eval_rigging.py artifact layout)")
    p.add_argument("--force", action="store_true",
                   help="recompute even when {name}_rig.txt exists (default skips)")
    p.set_defaults(fn=cmd_predict_rig)

    tr = sub.add_parser("track", help="tracking demo on the capsule")
    _add_common(tr)
    tr.add_argument("--out", default="results")
    tr.add_argument("--frames", type=int, default=6)
    tr.add_argument("--smooth-passes", type=int, default=2,
                    help="temporal quaternion-smoothing passes for the visualization "
                         "outputs (0 disables)")
    tr.set_defaults(fn=cmd_track)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
