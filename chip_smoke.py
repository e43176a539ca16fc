"""Smoke run of the PyTorch/CUDA port (morig_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # what the smoke check runs
    python3 chip_smoke.py --profile   # plus phase 5 and the training and tracking profiles

Phases, each printing its own lines:
  1. device  — requires CUDA; prints the card's name and power limit;
  2. build   — compiles the kernels from csrc/ with nvcc (sm_90a), one
               process per source, all started together;
  3. kernels — each of K1 (edge MLP, the forward of serving and of
               training), K2 (kNN + gather), K3 (row gather), K4 (kNN), K5
               (windowed edge MLP) and K6 (edge MLP backward) against its
               plain PyTorch version on the card, at the shapes the paths
               give it (K1 also on random full-table neighbours at H=128
               and 256 and at the training path's tables, printed apart
               from its serving sum; K5 also against K1, at B*T=20 and B=4;
               K6 at the training path's tables with exact ties, its
               recomputed forward against K1's output bit for bit, a
               second call's gradients against the first's bit for bit,
               and K6's dW2 kernel alone against its plain version; K2 also
               at the training step's vismask shape, printed apart from its
               three serving cases; and KS, the ordered row scatter, the
               port's own kernel behind K6's db_table and the backward of
               the training gathers, at K2's backward shapes and K6's
               training tables against `index_add_` and against itself
               run again, bit for bit, each with its launch plan, its
               reverse table's build and, at K6's tables, the same sum
               under K6's kernel name; and KG, the row-invariant fp32
               product, the port's own kernel behind every fp32 Dense and
               the masked means, at the training step's Dense shapes (and,
               printed apart from their sums, the two n-fast input
               gradients) against the float64 product within the summation
               bound, each half of its rows and of its columns and every
               route and tile its planner can be forced to against the
               whole call bit for bit, torch.matmul its plain version and
               library call, each shape's time beside the library's),
               with errors, tolerances, the least time the card could take
               (`bound_ms`) and two times per kernel: its device ms (the
               summed durations of its own launches under torch.profiler
               over REPS calls, / REPS; a profile that lost ops is taken
               again, and after three tries the time is CUDA events around
               REPS calls queued behind a spin kernel) and its call ms (CUDA events
               around REPS back-to-back calls, / REPS, which includes the
               wrapper's host time); the plain version's call ms, and
               where one PyTorch call computes the same function (K3's
               `values[bsel, idx]`) that call's device and call ms; beside
               K2 and K4 a library composite (bf16 bmm, mask, topk and
               K2's gather: several calls, a yardstick only);
  4. paths   — `RigPredictor.predict_rig_batch` on B=4 capsule meshes
               (V=1298 padded to 1536, degree-12 tables, P=1024, T=5) with
               seeded random weights (heads included), in two
               configurations.  Path 1: no voxels, euclidean skin
               distances, every edge layer on K1 (K6 = 0).  Path 2
               (bench.py phase A's serving configuration): an 88^3 voxel
               grid and the surface-geodesic matrix per mesh, a device
               cache, the edge dispatch `auto_select_edge_impl(entries,
               tile_v=128)` chooses, which must be the windowed K5, and
               JointNet's head scaled so shifted points land in the volume
               (`phase_a_predictor`).  Each: one warm-up call, then 7
               timed calls, each checked; the kernel counts
               are zeroed just before the first timed call and read just
               after it, and must equal the expected launches; prints the
               call's median and quartiles, meshes/s, per-phase medians and
               peak device memory;
  5. profile (--profile only) — for each path, each device program's
               CUDA-event time, its device ops and busy time under
               torch.profiler and the ported kernels' share, and their
               device ms per call summed over the three programs; CUDA-event
               times of FPS and the clustering;
  6. train   — `CorrPoseStage` (CorrNet, full width) on B=4 capsules
               (V=1298 padded to the 2048 bucket, degree-12 tables,
               P=1024, frame pair (0, 2), vismask branch on), from a seeded
               `init_state` on the card: one warm-up step, then 6 timed
               steps on the same batch, each checked (finite loss and
               gradient norm, parameters moved); the kernel counts are
               zeroed just before the first timed step and read just after
               it (K1 = K6 = 8, K2 = 1, K3 = 2, KS = 4, K4 = K5 = 0); then
               one `eval_step`.  Prints the step's median and quartiles,
               steps/s, peak device memory and the first and last total
               loss, which must be lower; with --profile also the step's
               device ops, busy time and idle share and K1's, K6's and
               K2's time.
  9. deform — `DeformPoseStage` on phase 6's batch, its extractor loaded
               from phase 6's final CorrNet (`init_extractor_from`) and
               frozen: a warm-up step whose K1 and K6 calls are recorded and
               held against their plain versions at their shapes, the eval
               loss (`eval_step`), 6 timed steps, each checked, the eval
               loss again, which must be lower; the counts of the first
               timed step must be K1 20, K2 3, K6 12, plain_edge 0, and the
               extractor must equal the loaded CorrNet bit for bit; then one
               step of a fresh stage with the extractor trained (K6 20, K3
               2, KS 8, the extractor moved).  Prints the step's median and quartiles,
               steps/s, peak memory, the losses and the last grad norm;
               with --profile one step's device ops, busy ms, idle share
               and K1's and K6's ms;
 10. rig     — `RigStage`, jointnet then masknet, at full width from seeded
               weights, on `creature_rig_dataset(num_models=4, seed=0)` at
               its defaults (about 1900 vertices in the 2048 bucket,
               degree-16 tables, T=5, up to 48 joints), B=4: as phase 9,
               with the embedding draws of `eval_step` from a fixed
               generator; counts K1 72, K6 72, K3 = KS = 18 (the
               multi-positive infoNCE's gathers), K2 0, plain_edge 0;
 11. skin    — `SkinStage` on the same batch, as phase 10.
 12. skel    — `BoneStage`, then `RootStage`, at full width from seeded
               weights on `creature_skel_dataset(num_models=4, seed=0)` at
               its defaults (`cli.py train bone|root --data creature`): 12
               rows (each creature's GT joints and two jittered copies), V
               in the 2048 bucket, degree-16 tables, J <= 32, P = 496.  One
               step first moves the zero-initialized head (until it does,
               every gradient behind it is 0), then as phase 9: counts K1 6,
               K6 6, K2 = K3 = 0, plain_edge 0 per step; then one
               `eval_step` counted apart: K1 6, K3 2 (BoneNet's joint-set
               SAs) or 4 (RootNet's SAs and fp2, fp1), its K1 and K3 calls
               recorded and held against their plain versions as in
               phase 7.
 13. demo    — `capsule_predictor(train_steps=12)` on the card (the stages
               trained on two small capsules, what `cli.py predict-rig`
               serves), then `predict_rig` on each of its pose models (points
               of frames 1-5), DEMO_CALLS calls each, each checked as in
               phase 7 (finite joints, skin rows summing to 1 within 1e-3,
               K1 one per edge layer, K2 = 3, K3 = 12); the first call on
               each capsule records its K1, K2 and K3 calls, each held
               against its plain version at its shape.  Prints the training
               seconds, the call median and the joint counts.
               Phases 9-13 run right after phase 6.
 14. batch   — the "batch" norm mode (MaskedBatchNorm in every MLP and
               edge tail, the mode of the reference's trained weights):
               the six networks built in it by `RigPredictor.random(0)`
               (BatchNorm statistics seeded too) serve path 1's
               configuration: a warm-up call whose K2 and K3 calls are
               recorded and held against their plain versions as in
               phase 7, then 5 timed calls, each checked as in phase 4,
               its counts zeroed before and read after it: K2 3, K3 12
               and no edge kernel (K1 = K5 = K6 = plain_edge = 0: the
               BatchNorm tail is plain fp32 PyTorch); then CorrPoseStage
               in that mode on phase 6's batch (a warm-up and 3 timed
               steps, finite, parameters and running statistics moved, K2
               1 a step) and one DeformPoseStage step with the extractor
               loaded from that CorrNet and frozen (K2 3): its parameters
               and running statistics must equal the loaded ones bit for
               bit, GCNDeform's statistics must move.  Prints the call and
               step medians, meshes/s, steps/s and peak memory; with
               --profile also the serving call's device programs and one
               CorrPoseStage step under torch.profiler.  Runs after phase
               13.
 15. cli     — the command line (`morig_tpu_torch.cli.main`) on the card
               in a temporary directory.  First a pose folder and a rig
               folder in the reference's layout for
               `creature_pose_dataset` / `creature_rig_dataset(num_models=4,
               seed=0)` at their defaults (V 1300-1900 in the 2048 bucket):
               each mesh written as OBJ and read back, its edge tables from
               `preprocess_model` (surface and volumetric geodesics, 88^3
               voxels, its .npz/.binvox cache), 101-frame trajectories with
               the 6 frames at the modelsresource keyframes 0, 20, ..., 100;
               both folders read back by `load_pose_models` /
               `load_rig_models` and held to the datasets.  Then, in order:
               train corr_pose (--epochs 1 --batch-size 4 --train-vismask),
               train corr_pose --edge-impl windowed on the capsule fixture
               (local tables: K5 in training and evaluation), train
               deform_pose --init-extractor (the extractor must equal the
               CorrNet bit for bit), eval deform --resume, train joints on
               the rig folder, predict-rig --save-intermediates
               --train-steps 2, eval rig against a GT folder of its
               `_gt_rig.txt` files, track --frames 2 and eval tracking.
               Each command's kernel counts are zeroed before it and read
               after it and must be its training steps' and evaluations'
               launches (train corr_pose: K1 8 + 8, K6 8, K2 1 + 1, K3 2 +
               6, KS 4; its windowed run the same with K5 in place of K1;
               train deform_pose: K1 20 + 20, K6 12, K2 3 + 3, K3 6; eval
               deform: K1 20, K2 3, K3 6; train joints: K1 2 x 72 + 2 x 72,
               K6 2 x 72, K3 = KS = 2 x 18; predict-rig: 2
               capsule_predictor steps of K1 = K6 = 72 + 72 + 6 + 6, K3 =
               KS = 18 + 18, then 2 predict_rig calls of K1 one per edge
               layer, K2 3, K3 12; track: 1 frame of K1 20, K2 3, K3 6; the
               evals of folders none); its first K1, K2, K3 and KS calls
               and its training K1/K5/K6 calls of each shape are held
               against their plain versions (`check_recorded`,
               `check_recorded_training`); its outputs must be finite and
               its files exist; it prints its wall seconds and peak
               memory.
 16. repro   — repeatable training (after phase 13): each of the seven
               training steps (CorrPoseStage, DeformPoseStage, RigStage
               jointnet, SkinStage, BoneStage, RootStage on phases 6, 10
               and 12's batches, CorrPoseStage in "batch" norm mode), a
               seeded init and 3 steps, run twice: every loss, gradient,
               parameter and running statistic equal bit for bit
               (`train.repro`); and `capsule_predictor` again: the joint
               counts and the four trained networks' parameters equal to
               phase 13's.  The first tensor that differs is printed, and
               any difference fails the run.
 17. k5 train — training through the windowed kernel (after phase 14):
               CorrPoseStage on phase 6's batch with the dataset's
               edge_tile=128, and RigStage jointnet on 4 capsules at phase
               6's size (degree-16 rig tables; phase 10's creatures are not
               local at the tile, also in RCM order),
               `auto_select_edge_impl` "windowed" for both; each as phase
               10 (its K5 calls held against their plain version and
               against K6's recomputed forward bit for bit; counts K5 in
               place of K1), then on the full table (K1); then both take 6
               rounds of steps in the order K5 K1 K1 K5, their losses equal
               step for step, and the medians side by side.
 18. f32     — path 1 with `set_inference_dtype("f32")`: phase 4's checks
               and counts, and its call median beside path 1's.
 19. parallel — data- and tensor-parallel training (last, after phase 8):
               each of the seven stages' steps and the "batch"-mode
               CorrPoseStage's (phases 6, 10 and 12's batches, seeded
               random weights) on one device, then sharded at data = 2,
               and DeformPoseStage and the "batch"-mode CorrPoseStage at
               model = 2 and data = 2 x model = 2 (ranks spawned with
               `parallel.sharding.spawn`: NCCL with one rank per card where
               there are as many cards, else gloo with the ranks on the
               cards, printed); each held to the one-device step on the
               global batch (losses, every gradient before the clip,
               running statistics) at the CPU tests' tolerances (the
               "batch" mode at the train tests'; a failure first runs the
               split comparison `parallel.steps.split_sources` on its case
               and prints the first call whose rows part) with rank 0's
               counts and its recorded K1/K2/K3/K6/KS calls checked; the
               2 x 2 deform step twice,
               bit for bit (a difference names its collective); NCCL once
               at world size 1; `dryrun_multichip(4)`.  Prints each step
               median beside the one-device median, each rank's peak
               memory, the backend and the ranks per card.
 20. scanned — epoch-scanned training (last, after phase 19): for
               CorrPoseStage on phase 6's dataset (batch 4, the visibility
               branch from epoch 3: 7 epochs in chunks [0, 2), [2, 3) cut
               short at the branch, [3, 5), [5, 7)), the same through K5
               (the dataset's edge_tile=128, as phase 17), RigStage
               jointnet on `creature_rig_dataset(num_models=4, seed=0)` and
               BoneStage on phase 12's batch (`const_scan_batcher`), each
               from the same seeded weights, generator and schedule draws
               through `run_epochs` and `run_epochs_scanned` (train/
               scanned.py: each step a CUDA-graph replay, train/graphs.py),
               both writing checkpoints: the final weights and buffers, the
               best epoch and the logged metrics equal bit for bit; one
               host fetch per chunk (the replays run under sync debug mode
               "error"); the scanned run's launches (warm-ups counted by
               the wrappers, replays by `graphs.replayed_launches`) equal
               the loop's plus one eager warm-up of each program per
               capture, every kernel the loop launched also replayed, and
               the train graph's launches per replay the stage's per-step
               counts.  Prints each runner's seconds, epoch seconds and
               steps/s over the chunks that captured nothing, the card's
               name and power limit; with --profile an eager train step's
               device ops, busy ms and idle share beside a replayed one's
               (`scanned.step_program`).
 21. campaign — the convergence campaign at its smoke size (last, after
               phase 20): `tools/torch_campaign.py --smoke` in a temporary
               directory (2 training, 1 validation and 1 held-out creature
               of ~700 vertices, P=256, batch 2; the eight stages corr,
               deform, deform_seq, joints, mask, skin, bone and root 3
               epochs each through `run_epochs_scanned`, each step a
               CUDA-graph replay; the flow dumps; the held-out
               `predict_rig_batch` with voxels and surface geodesics, the
               skin L1 and the tracking of creature 200 by both DeformNets
               over 10 frames), then `tools/torch_eval_campaign_tracking.py
               --frames 5 --timing-iters 1` on it, both in this process
               with the counts zeroed before and read after each: the
               campaign must launch K1, K2, K3, K6 and KS, the tracking K1,
               K2 and K3, neither K4, K5 or `plain_edge`; every recorded
               K1/K2/K3/KS call (first of each shape) and every training
               K1/K6 call is held against its plain version as in phases
               7 and 15; the summary must be finite with IoU, precision and
               recall in [0, 1] and skin L1 >= 0, the tracks finite and each
               stage's files written.  Prints each stage's seconds, epochs
               and peak memory, the held-out timings and tracked frames/s.
 22. sweep   — the last JAX tools' counterparts (last, inside phase 21's
               temporary directory): (a) `tools/torch_sweep_joint_params.py`
               on the card on campaign_v3/joint_sweep_inputs.npz (read in
               place, the result written to a temporary directory) with the
               default grid: the best thresholds and every held-out
               creature's joint count equal to campaign_v3/
               joint_sweep_result.json's, IoU, precision, recall and
               chamfer within SWEEP_TOL; (b) its --dump on phase 21's
               campaign directory (that run's validation and held-out
               creatures and sizes): the K1 launches of two JointNet and
               two MaskNet forwards and nothing else, every K1 call (first
               of each shape) held against its plain version, the arrays
               finite and some shifted points inside each volume; (c)
               `examples/torch_capsule_end_to_end.py --steps EXAMPLE_STEPS`:
               finite metrics, a rig file, its `predict_rig` call counted as
               phase 13's (K1 one per edge layer, K2 3, K3 12, nothing
               else), its K1/K2/K3/KS calls and training K1/K6 calls held
               against their plain versions.  Prints each part's seconds.
  7. single mesh — `RigPredictor.predict_rig` (the single-mesh API) with
               path 1's predictor on the first capsule request (V=1298
               padded to 1536, P=1024, T=5): a warm-up call whose K1, K2
               and K3 calls are recorded and each held against its plain
               version at its shape, then 5 timed calls, each checked
               (finite joints, skin rows summing to 1 within 1e-3, kernel
               counts zeroed before and read after each call: K1 one per
               edge layer call, K2 = 3, K3 = 12); prints the median, the
               stage medians (flow, shift_attn, joints, skel, skin) and the
               joint count beside predict_rig_batch's on the same mesh;
  8. tracking — `make_scanned_tracker(Tracker(...))` with path 1's DeformNet
               on the capsule sequence at `cli.py track`'s size (V=274
               padded to 1024, degree-16 tables, P=256) and
               `BatchedTracker.make_scanned()` on NB=4 creatures at bench.py
               phase B2's configuration (seeds 100-103, P=512, at most 900
               vertices, the 1024 bucket, degree-12 tables, joints rounded
               up to a multiple of 8), each over 6 frames (5 tracked; B2
               runs 21) with the full 200 + 400 IK iterations: a warm-up
               run whose kernel calls are held against the plain versions
               as in phase 7, then a timed run with the counts zeroed
               before it (per step, one frame of every sequence: K1 one
               per DeformNet edge layer, K2 = 3, K3 = 6); prints tracked
               frames/s (all sequences), ms per step split into flow and
               IK (stage 1, gate, stage 2), peak memory and the counts,
               and checks that trajectories and vismasks are finite and
               quaternions of unit norm; with --profile also one step's
               device ops, busy ms and idle share for the flow and the IK
               half.
Then a JSON line of kernel results, KS among them (launches counted in
the main paths' counted runs: path 1, path 2, the training step, the first
timed step of each of phases 9-12 and 17 (its K5 steps) and phase 9's step
with the extractor trained, phase 12's counted `eval_step`s, phase 13's
calls, phase 14's timed calls and steps, phase 18's first timed call,
phase 15's commands, the first timed single-mesh call, the two timed
tracking runs, rank 0's first step of each phase-19 run, every run of
phase 20 and phase 21's two runs, a graph replay counted as the launches
its capture recorded;
`ms` and `device_ms`
the device time, `call_ms` the call time, `library_ms` and
`library_device_ms` the library call's, `composite_ms` and
`composite_device_ms` K2's and K4's composite's), the card's name and power limit,
and last `{"ok": true, "device": {...}}`.  Any failure
raises: the exit code is non-zero and the last line is not printed.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from morig_tpu_torch import cli, native
from morig_tpu_torch.core.batch import build_mesh, pad_to, stack_meshes
from morig_tpu_torch.data import loaders, preprocess
from morig_tpu_torch.data.creature import (creature_pose_dataset, creature_rig_dataset,
                                           creature_skel_dataset, make_creature_sequence)
from morig_tpu_torch.data.loaders import load_pose_models, load_rig_models
from morig_tpu_torch.data.mesh_io import read_obj, write_obj
from morig_tpu_torch.data.pose import PoseDataset, capsule_pose_dataset
from morig_tpu_torch.data.preprocess import preprocess_model
from morig_tpu_torch.data.rig import capsule_rig_dataset
from morig_tpu_torch.data.synthetic import capsule_batch, make_capsule_rig, make_capsule_sequence
from morig_tpu_torch.geometry import geodesic
from morig_tpu_torch.geometry import skeleton as sk
from morig_tpu_torch.geometry.geodesic import surface_geodesic
from morig_tpu_torch.geometry.voxel import voxelize_mesh
from morig_tpu_torch.kernels import build as kb
from morig_tpu_torch.kernels.edge_fused import (
    bwd_step_tiles, edge_mlp_bwd_plain, edge_mlp_dw2_plain, edge_mlp_plain,
    edge_mlp_windowed_plain, fused_edge_mlp, fused_edge_mlp_bwd, fused_edge_mlp_dw2,
    fused_edge_mlp_windowed)
from morig_tpu_torch.kernels import gather_fused, knn_fused
from morig_tpu_torch.kernels.gemm import gemm, gemm_plain, sm_count
from morig_tpu_torch.kernels import neighbors as nbk
from morig_tpu_torch.kernels.gather_fused import (gather_plain, gather_rows, plan_scatter,
                                                  reverse_table, row_scatter_launch,
                                                  scatter_rows, scatter_rows_plain)
from morig_tpu_torch.kernels.knn_fused import NEG, knn_batched, knn_plain, knn_topk
from morig_tpu_torch.nn import corrnet, deformnet, gcu, pointnet
from morig_tpu_torch.nn.corrnet import l2_normalize
from morig_tpu_torch.nn.gcu import EdgeMLP, auto_select_edge_impl
from morig_tpu_torch.nn.mlp import get_default_norm, set_default_norm, set_inference_dtype
from morig_tpu_torch.parallel import steps
from morig_tpu_torch.parallel.dryrun import dryrun_multichip
from morig_tpu_torch.parallel.sharding import (make_device_mesh, shard_batch, shard_state,
                                               spawn)
from morig_tpu_torch.pipelines.rig_predict import RigPredictor, StageTimer, capsule_predictor
from morig_tpu_torch.pipelines.tracking import BatchedTracker, Tracker, make_scanned_tracker
from morig_tpu_torch.train.graphs import replayed_launches, reset_replayed
from morig_tpu_torch.train.repro import first_difference, run_steps
from morig_tpu_torch.train.scanned import (_chunk_ranges, const_scan_batcher, pose_scan_batcher,
                                           rig_scan_batcher, run_epochs_scanned, step_program)
from morig_tpu_torch.train.stages import (BoneStage, CorrPoseStage, DeformPoseStage, RigStage,
                                          RootStage, SkinStage)
from morig_tpu_torch.train.trainer import MetricLogger, run_epochs

B_MESH, T, P, V_PAD, DEGREE = 4, 5, 1024, 1536, 12
EDGE_TILE, VOX_DIMS = 128, 88
# K1: the kernel and the plain version round LN1 outputs (|h| up to ~6) to
# bf16 from fp32 values that differ in the last bits, so a rare element
# lands one bf16 ulp (2^-8 relative) apart; through W2 and LN2 that moves
# an O(1) output by up to ~2e-2.  The mean error stays at fp32 level
# (below 7e-7 at every width on the H100), so it is held to 1e-5.
K1_TOL, K1_MEAN_TOL = 3e-2, 1e-5
# K5 is K1's arithmetic with the rows read from the window: the same
# bounds, K5 against its plain version and against K1 (the tables are
# local).
K2_TOL = 1e-5     # fp32 sums of exact bf16 products, in another order; K4 too
# K6 against its plain version.  Both round h, ds and dx to bf16 from fp32
# values summed in another order, so a rare element lands one bf16 ulp
# apart; where that happens at a near-tie of the max, the route flips: dout
# moves to another edge, which changes one column of dW2, one entry of each
# H2-wide vector gradient and one vertex's rows of da and db_table (measured
# on the H100 at H=256 and 36K valid edges: about one column of dW2 off by up
# to 1.6% of its scale).  So every gradient is held by its relative L2
# error (K6_L2_TOL), and da and db_table, whose entries a flip touches only
# for one vertex, also by their entries: fewer than K6_FRAC_TOL of them off
# by more than K6_ELEM_TOL * max(max |plain|, 1).
K6_L2_TOL, K6_ELEM_TOL, K6_FRAC_TOL = 1e-2, 1e-3, 1e-3
# K6's dW2 kernel alone: the plain version's bf16 products summed in fp32 in
# another order
K6_DW2_TOL = 1e-5
# The ordered row scatter against `index_add_` on the card, whose atomics add
# in no fixed order: fp32 sums of the same rows in another order, within
# KS_TOL * max(max |plain|, 1); against itself run again, bit for bit.
KS_TOL = 1e-5
K6_NAMES = ("da", "db_table", "dw2", "db2", "dg1", "dbe1", "dg2", "dbe2")
REPS = 20         # calls per kernel timing (and CUDA-event samples of the profiles)
MEDIANS: dict = {}  # each timed path's call median and each timed stage's step median, ms
MAIN_REPS = 7     # timed calls of predict_rig_batch after the warm-up
TRAIN_B, TRAIN_STEPS = 4, 6      # training batch, timed steps after the warm-up
# The H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W): HBM
# bytes/s and bf16 tensor-core FLOP/s.  A kernel's bound is the larger of its
# bytes (each input read once, each output written once) over the first and
# its products' FLOPs (on the valid edges this run's tables hold) over the
# second.
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12
FP32_FLOPS = 67e12        # without the tensor cores: the row-invariant product KG


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes' and the products' time
    (at `peak` FLOP/s)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timings:
    """A kernel's results summed over the calls phase 3 makes of it: max
    error; the kernel's device ms and call ms, the plain version's call ms,
    the library call's call and device ms; and the bound (with what bounds
    the call of the largest bound)."""

    def __init__(self):
        self.err = self.device_ms = self.call_ms = self.plain_ms = self.bound_ms = 0.0
        self.library_ms = self.library_device_ms = None
        self.composite_ms = self.composite_device_ms = None
        self.bound_by, self._worst = "bytes", -1.0

    def add(self, err, kernel, plain_ms, n_bytes, flops, library=None, composite=None,
            peak=BF16_FLOPS):
        """kernel, library, composite: (device ms, call ms) pairs from
        `kernel_ms`; the composite (several PyTorch calls, K2 and K4 only) is
        a yardstick apart from the library call; `peak`: the FLOP/s of the
        products' type."""
        b, by = bound(n_bytes, flops, peak)
        self.err, self.plain_ms = max(self.err, err), self.plain_ms + plain_ms
        self.device_ms += kernel[0]
        self.call_ms += kernel[1]
        self.bound_ms += b
        if b > self._worst:
            self._worst, self.bound_by = b, by
        if library is not None:
            self.library_device_ms = (self.library_device_ms or 0.0) + library[0]
            self.library_ms = (self.library_ms or 0.0) + library[1]
        if composite is not None:
            self.composite_device_ms = (self.composite_device_ms or 0.0) + composite[0]
            self.composite_ms = (self.composite_ms or 0.0) + composite[1]
        return b

    def json(self) -> dict:
        return {"max_abs_err": self.err, "ms": self.device_ms, "device_ms": self.device_ms,
                "call_ms": self.call_ms, "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
                "bound_by": self.bound_by, "library_ms": self.library_ms,
                "library_device_ms": self.library_device_ms,
                "composite_ms": self.composite_ms,
                "composite_device_ms": self.composite_device_ms}


def median_ms(fn) -> float:
    fn()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def call_ms(fn) -> float:
    """CUDA events around REPS back-to-back calls after a warm-up, over REPS:
    the device's time per call, including any wait on the host's wrapper."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def queued_ms(fn) -> float:
    """Device ms per call without the profiler: CUDA events around REPS calls
    queued behind a spin kernel that outlasts the host's queueing, so the
    card runs them back to back and no host time enters (the call's other
    device ops, such as K5's W2 layout, do)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    ahead = not start.query()
    torch.cuda.synchronize()
    if not ahead:
        raise AssertionError("the card finished the spin before the host had queued the calls")
    return start.elapsed_time(end) / REPS


# Timing by torch.profiler: host sleep before and after the profiled calls,
# so that device ops whose timestamps the trace places outside the host's
# window are kept, and tries before device ms falls back to `queued_ms`.  A
# run lost every K5 op of one 20-call profile; the trace can place a device
# op milliseconds before the host call that launched it (the device and host
# clocks disagree).  Tries, fallbacks and the least start - launch are
# printed at the end of phase 3.
PROFILE_PAD_S, PROFILE_TRIES = 0.05, 3
SPIN_CYCLES = 50_000_000          # ~25 ms at the H100's clocks
PROFILER_STATS = {"timings": 0, "retried": 0, "fell_back": 0, "least_skew_us": math.inf}


def launch_skew_us(prof) -> float:
    """The least (device op's start - its launch call's start) in a profile,
    µs: below 0, the trace puts device ops before the host launched them."""
    from torch.autograd import DeviceType

    ev = prof.profiler.kineto_results.events()
    launch = {e.correlation_id(): e.start_ns() for e in ev if "LaunchKernel" in e.name()}
    starts = [e.start_ns() - launch[e.correlation_id()] for e in ev
              if e.device_type() == DeviceType.CUDA and e.correlation_id() in launch]
    return min(starts, default=math.inf) / 1e3


def kernel_ms(fn, name=None, split=None) -> tuple[float, float]:
    """(device ms, call ms) of fn.  Device ms: under torch.profiler, the
    summed durations of the device ops of REPS calls whose name contains
    `name` (or one of a tuple of names; every device op of the calls where
    name is None), over REPS: the kernel's own time on the card, without its
    wrapper's host time.  Each call launches the same ops, so a profile must
    hold a whole, non-zero multiple of REPS of them, else it is taken again;
    after PROFILE_TRIES it is `queued_ms` instead.  `split` (a dict), where
    given, gets each name's device ms per call (left empty after a
    fallback)."""
    from torch.profiler import ProfilerActivity, profile

    t_call = call_ms(fn)
    names = (name,) if isinstance(name, str) else name
    PROFILER_STATS["timings"] += 1
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        ops = [e for e in device_events(prof) if name is None or any(n in e.name for n in names)]
        PROFILER_STATS["least_skew_us"] = min(PROFILER_STATS["least_skew_us"],
                                              launch_skew_us(prof))
        if len(ops) >= REPS and len(ops) % REPS == 0:
            PROFILER_STATS["retried"] += attempt > 0
            if split is not None:
                split.update({n: sum(e.time_range.elapsed_us() for e in ops if n in e.name)
                              / 1e3 / REPS for n in names})
            return sum(e.time_range.elapsed_us() for e in ops) / 1e3 / REPS, t_call
        print(f"profiler: {len(ops)} device ops named {name!r} in {REPS} calls (try "
              f"{attempt + 1} of {PROFILE_TRIES})")
    PROFILER_STATS["fell_back"] += 1
    t_dev = queued_ms(fn)
    print(f"profiler: device ms of {name!r} from events behind a spin instead: {t_dev:.4f} ms")
    return t_dev, t_call


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

EDGE_WIDTHS = (16, 32, 64, 128, 256)
TRAIN_WIDTHS = (16, 32, 128, 256)      # CorrNet's edge layers (K1 and K6 in training)
RANDOM_WIDTHS = (128, 256)             # K1 on random full-table neighbours


def edge_args(dev, nbr, mask, H, g):
    Bt, V, _ = nbr.shape
    a = torch.randn(Bt, V, H, device=dev, generator=g).to(torch.bfloat16)
    b = torch.randn(Bt, V, H, device=dev, generator=g).to(torch.bfloat16)
    w2 = torch.randn(H, H, device=dev, generator=g) / math.sqrt(H)
    vecs = [0.1 * torch.randn(H, device=dev, generator=g),
            torch.rand(H, device=dev, generator=g) + 0.5,
            0.1 * torch.randn(H, device=dev, generator=g),
            torch.rand(H, device=dev, generator=g) + 0.5,
            0.1 * torch.randn(H, device=dev, generator=g)]
    return (a, b, nbr, mask, w2, *vecs)


def edge_cost(args, out_bytes: int, passes: int):
    """Bytes (inputs once, outputs once) and bf16 FLOPs of `passes` (E, H1) x
    (H1, H2) products over the E valid edges."""
    mask, w2 = args[3], args[4]
    return nbytes(*args) + out_bytes, passes * 2.0 * int(mask.sum()) * w2.shape[0] * w2.shape[1]


def random_tables(dev, Bt, V, D, g):
    """Neighbours drawn uniformly from the whole mesh (no locality) and 70%
    of the slots valid, as the card tests' K1 cases."""
    nbr = torch.randint(0, V, (Bt, V, D), device=dev, generator=g)
    return nbr, torch.rand(Bt, V, D, device=dev, generator=g) < 0.7


def _edge_check(name, fn, plain, args, H, tables, kernel):
    """fn against plain on args within K1_TOL/K1_MEAN_TOL; returns (error,
    (device ms, call ms), plain call ms, bound ms) and prints them."""
    got, ref = fn(*args), plain(*args)
    torch.cuda.synchronize()
    e, e_mean = (got - ref).abs().max().item(), (got - ref).abs().mean().item()
    t_k = kernel_ms(lambda: fn(*args), DEVICE_NAMES[kernel])
    t_p = call_ms(lambda: plain(*args))
    b = bound(*edge_cost(args, nbytes(got), 1))[0]
    Bt, V, D = args[2].shape
    print(f"{kernel} {name} {tables} B={Bt} V={V} D={D} H={H}: max_abs_err {e:.3g} (tol "
          f"{K1_TOL}), mean {e_mean:.3g} (tol {K1_MEAN_TOL}); kernel device {t_k[0]:.4f} ms call "
          f"{t_k[1]:.4f} ms; plain {t_p:.4f} ms; bound {b:.4f} ms")
    if not (e <= K1_TOL and e_mean <= K1_MEAN_TOL):
        raise AssertionError(f"{kernel} disagrees with its plain version at {tables} H={H}: "
                             f"{e}, {e_mean}")
    return e, t_k, t_p, got


def check_k1(dev, mesh_bt):
    """Every edge width of the paths, over the B*T tables of the flow program;
    then H=128 and 256 on random full-table neighbours of the same size,
    whose time is printed beside the capsule tables' (not in the sum)."""
    g = torch.Generator(device=dev).manual_seed(1)
    Bt, V, D = mesh_bt.tpl_nbr.shape
    res, capsule = Timings(), {}
    for H in EDGE_WIDTHS:
        args = edge_args(dev, mesh_bt.tpl_nbr, mesh_bt.tpl_mask, H, g)
        e, t_k, t_p, got = _edge_check("edge_mlp", fused_edge_mlp, edge_mlp_plain, args, H,
                                       "capsule tables", "K1")
        res.add(e, t_k, t_p, *edge_cost(args, nbytes(got), 1))
        capsule[H] = t_k[0]
    print(f"K1 over the five widths on the capsule tables at B={Bt}: device {res.device_ms:.4f} "
          f"ms (PR 4's WMMA kernel: {K1_DEVICE_MS_BEFORE} ms), call {res.call_ms:.4f} ms")
    for H in RANDOM_WIDTHS:
        nbr, mask = random_tables(dev, Bt, V, D, g)
        args = edge_args(dev, nbr, mask, H, g)
        _, t_k, _, _ = _edge_check("edge_mlp", fused_edge_mlp, edge_mlp_plain, args, H,
                                   "random tables", "K1")
        print(f"K1 random vs capsule tables at H={H}: device {t_k[0]:.4f} vs {capsule[H]:.4f} ms "
              f"(random/capsule {t_k[0] / capsule[H]:.3f})")
    return res


def check_k1_training(dev, mesh):
    """K1 as the training forward: the training path's widths over its
    tables (B=4, V=2048, D=12, the capsules PoseDataset pads), summed and
    printed apart from K1's serving row."""
    g = torch.Generator(device=dev).manual_seed(7)
    res = Timings()
    for H in TRAIN_WIDTHS:
        args = edge_args(dev, mesh.tpl_nbr, mesh.tpl_mask, H, g)
        e, t_k, t_p, got = _edge_check("edge_mlp", fused_edge_mlp, edge_mlp_plain, args, H,
                                       "training tables", "K1")
        res.add(e, t_k, t_p, *edge_cost(args, nbytes(got), 1))
    print(f"K1 over the four training widths at the training tables: device "
          f"{res.device_ms:.4f} ms (the training forward before it ran K1: "
          f"{TRAIN_FWD_DEVICE_MS_BEFORE} ms), call {res.call_ms:.4f} ms; plain "
          f"{res.plain_ms:.4f} ms; bound {res.bound_ms:.4f} ms")


def check_k5(dev, mesh_bt, mesh_b):
    """Every edge width of the paths over the B*T tables of the flow program
    and the B tables of the trunks (local at the dispatch tile): K5 against
    its plain version and against K1, and K5's device time beside K1's on the
    same tables.  The kernel row sums the B*T shapes, as K1's does."""
    g = torch.Generator(device=dev).manual_seed(1)
    res = Timings()
    sums = {}
    for mesh in (mesh_bt, mesh_b):
        Bt, V, D = mesh.tpl_nbr.shape
        for H in EDGE_WIDTHS:
            args = edge_args(dev, mesh.tpl_nbr, mesh.tpl_mask, H, g)
            got = fused_edge_mlp_windowed(*args, tile_v=EDGE_TILE)
            ref = edge_mlp_windowed_plain(*args, tile_v=EDGE_TILE)
            k1 = fused_edge_mlp(*args)
            torch.cuda.synchronize()
            e, e_mean = (got - ref).abs().max().item(), (got - ref).abs().mean().item()
            e1, e1_mean = (got - k1).abs().max().item(), (got - k1).abs().mean().item()
            t_k = kernel_ms(lambda: fused_edge_mlp_windowed(*args, tile_v=EDGE_TILE),
                            DEVICE_NAMES["K5"])
            t_1 = kernel_ms(lambda: fused_edge_mlp(*args), DEVICE_NAMES["K1"])
            t_p = call_ms(lambda: edge_mlp_windowed_plain(*args, tile_v=EDGE_TILE))
            cost = edge_cost(args, nbytes(got), 1)
            b = res.add(e, t_k, t_p, *cost) if mesh is mesh_bt else bound(*cost)[0]
            k5, k1s = sums.setdefault(Bt, ([0.0, 0.0], [0.0, 0.0]))
            k5[0], k5[1], k1s[0], k1s[1] = (k5[0] + t_k[0], k5[1] + t_k[1], k1s[0] + t_1[0],
                                            k1s[1] + t_1[1])
            print(f"K5 edge_mlp_windowed B={Bt} V={V} D={D} H={H} tile={EDGE_TILE}: max_abs_err "
                  f"{e:.3g} (tol {K1_TOL}), mean {e_mean:.3g} (tol {K1_MEAN_TOL}); against K1 max "
                  f"{e1:.3g}, mean {e1_mean:.3g}; device K5 {t_k[0]:.4f} ms K1 {t_1[0]:.4f} ms "
                  f"(K1/K5 {t_1[0] / t_k[0]:.3f}); call K5 {t_k[1]:.4f} ms K1 {t_1[1]:.4f} ms; "
                  f"plain {t_p:.4f} ms; bound {b:.4f} ms")
            if not (e <= K1_TOL and e_mean <= K1_MEAN_TOL and e1 <= K1_TOL
                    and e1_mean <= K1_MEAN_TOL):
                raise AssertionError(f"K5 disagrees with its plain version or K1 at B={Bt} H={H}")
    for Bt, (k5, k1s) in sums.items():
        print(f"K5 vs K1 over the five widths at B={Bt}: device {k5[0]:.4f} ms vs {k1s[0]:.4f} ms "
              f"(K1/K5 {k1s[0] / k5[0]:.3f}); call {k5[1]:.4f} ms vs {k1s[1]:.4f} ms")
    return res


def k6_agree(got, ref, where: str):
    """K6's gradients against the plain version's: each within K6_L2_TOL
    relative L2 and finite, da and db_table also by their entries (fewer
    than K6_FRAC_TOL off by more than K6_ELEM_TOL * max(max |plain|, 1)).
    Returns (the largest entry error, one description per gradient);
    raises where they disagree."""
    worst, parts = 0.0, []
    for name, x, y in zip(K6_NAMES, got, ref):
        err = (x - y).abs()
        rel = ((x - y).norm() / y.norm().clamp(min=1e-30)).item()
        frac = (err > K6_ELEM_TOL * max(y.abs().max().item(), 1.0)).float().mean().item()
        parts.append(f"{name} max {err.max().item():.3g} mean {err.mean().item():.3g} "
                     f"rel L2 {rel:.3g} (tol {K6_L2_TOL}) off {frac:.2g}")
        per_vertex = name in ("da", "db_table")
        if not (torch.isfinite(x).all() and rel <= K6_L2_TOL
                and (frac <= K6_FRAC_TOL or not per_vertex)):
            raise AssertionError(f"K6 disagrees with its plain version at {where}: {parts[-1]}")
        worst = max(worst, err.max().item())
    return worst, parts


def check_k6(dev, mesh):
    """The training path's edge widths over its tables (B=4, V=2048, D=12,
    the capsules PoseDataset pads), with neighbour column 1 a copy of column
    0 (exact ties in the max) and a seeded dout: every gradient against the
    plain version's, K6's recomputed forward against K1's output bit for bit
    (the invariant of its max routing), and K6's dW2 kernel alone against its
    plain version over the tiles packed from the plain backward's h and ds.
    K6 is called with the table's reverse table built once, as the edge
    layers pass a MeshBatch's, and again without it (built inside), which
    must give the same gradients bit for bit.  Prints the device
    ms of each of K6's kernels (main, dW2, the fixed-order sums, the
    db_table sum) and their sum over the four widths beside the kernel's
    before the ordered db_table."""
    g = torch.Generator(device=dev).manual_seed(6)
    nbr, mask = mesh.tpl_nbr.clone(), mesh.tpl_mask.clone()
    nbr[:, :, 1], mask[:, :, 1] = nbr[:, :, 0], mask[:, :, 0]
    Bn, V, D = nbr.shape
    rev = reverse_table(nbr, V, mask)
    res = Timings()
    for H in TRAIN_WIDTHS:
        args = edge_args(dev, nbr, mask, H, g)
        dout = torch.randn(Bn, V, H, device=dev, generator=g)
        got, fwd = fused_edge_mlp_bwd(*args, dout, return_forward=True, rev=rev)
        again = fused_edge_mlp_bwd(*args, dout)
        ref = edge_mlp_bwd_plain(*args, dout)
        same = torch.equal(fwd, fused_edge_mlp(*args))
        repeats = all(torch.equal(x, y) for x, y in zip(got, again))
        torch.cuda.synchronize()
        if not same:
            raise AssertionError(f"K6's recomputed forward is not K1's output at H={H}")
        if not repeats:
            raise AssertionError(f"K6's gradients differ between two calls at H={H}")
        worst, parts = k6_agree(got, ref, f"H={H}")
        tiles, live = bwd_step_tiles(*args, dout)
        dw2_ref = edge_mlp_dw2_plain(tiles, live)
        dw2_err = ((fused_edge_mlp_dw2(tiles, live) - dw2_ref).norm() / dw2_ref.norm()).item()
        if not dw2_err <= K6_DW2_TOL:
            raise AssertionError(f"K6's dW2 kernel disagrees with its plain version at H={H}: "
                                 f"rel L2 {dw2_err}")
        del tiles
        split: dict = {}
        t_k = kernel_ms(lambda: fused_edge_mlp_bwd(*args, dout, rev=rev), DEVICE_NAMES["K6"],
                        split)
        t_p = call_ms(lambda: edge_mlp_bwd_plain(*args, dout))
        b = res.add(worst, t_k, t_p, *edge_cost(args + (dout,), nbytes(*got), 3))
        print(f"K6 edge_mlp_bwd B={Bn} V={V} D={D} H={H} ({int(mask.sum())} valid edges, "
              f"{int(live.sum())} of {live.numel()} steps live): " + "; ".join(parts)
              + f"; dW2 kernel alone rel L2 {dw2_err:.3g} (tol {K6_DW2_TOL}); kernel device "
              f"{t_k[0]:.4f} ms (" + ", ".join(f"{n} {t:.4f}" for n, t in split.items())
              + f") call {t_k[1]:.4f} ms; plain {t_p:.4f} ms; bound {b:.4f} ms; recomputed "
              f"forward equals K1's: {same}; a second call (reverse table built inside) "
              f"equal bit for bit: {repeats}; per-edge dx rows {int(mask.sum()) * H * 2 / 1e6:.2f} MB written "
              f"and read once")
    print(f"K6 over the four widths at the training tables: device {res.device_ms:.4f} ms (with "
          f"db_table summed by atomics, before the ordered scatter: {K6_DEVICE_MS_BEFORE} ms), "
          f"call {res.call_ms:.4f} ms")
    return res


def scatter_agree(got, again, ref) -> tuple[float, bool]:
    """(error, agrees): the ordered scatter within KS_TOL of the plain
    version (`index_add_`) and equal to itself run again."""
    e = (got - ref).abs().max().item() if got.numel() else 0.0
    return e, e <= KS_TOL * max(ref.abs().max().item() if ref.numel() else 0.0, 1.0) and \
        torch.equal(got, again)


def check_scatter(dev, mesh):
    """The ordered row scatter at the training path's shapes: K2's backward
    (the vismask 1-NN: B=4, 2048 queries, k=1, into 1024 points, 64 wide,
    the two scatters of its backward) through `scatter_rows` with its
    reverse table built on the card; K6's db_table over the training tables
    (B=4, V=2048, D=12) at the four training widths, bf16 dx rows of the
    valid edges (the batch's `tpl_rev`, as K6 sums db_table).  Each against
    `index_add_` (the plain version, and the library call timed beside it)
    within KS_TOL, and against itself run again bit for bit.  The device ms
    is the kernel's; the reverse table's build (a stable sort) is timed
    apart: a MeshBatch builds one per table, `scatter_rows` one per call.
    Each shape prints its launch (`plan_scatter`: route, lanes per target
    row, rows per warp, block), and K6's shapes also the device ms of the
    same sum launched under K6's name (`edge_db_sum_kernel`, the db_table
    sum inside each K6 call).  The bound counts the bytes the kernel's
    function must move: the rows it sums (every row at K2's shapes, the
    valid edges' at K6's), the reverse table's order entries of those rows
    and its offsets, and the output."""
    g = torch.Generator(device=dev).manual_seed(8)
    res = Timings()
    cases = []
    idx = torch.randint(0, P, (TRAIN_B, 2048, 1), device=dev, generator=g)
    rows = torch.randn(TRAIN_B, 2048, 1, 64, device=dev, generator=g)
    cases.append(("K2 backward (vismask 1-NN)", idx, rows, P, None))
    Bn, V, D = mesh.tpl_nbr.shape
    for H in TRAIN_WIDTHS:
        rows = torch.randn(Bn, V, D, H, device=dev, generator=g).to(torch.bfloat16)
        cases.append((f"K6 db_table H={H}", mesh.tpl_nbr, rows, V, mesh.tpl_mask))
    for name, idx, rows, n, mask in cases:
        C = rows.shape[-1]
        flat = rows.reshape(-1, C)
        db_sum = ""
        if mask is None:
            fn = lambda: scatter_rows(idx, rows, n)              # noqa: E731
            src = rows
        else:
            order, offsets = mesh.tpl_rev
            fn = lambda: row_scatter_launch(flat, order, offsets, Bn * n)   # noqa: E731
            src = rows * mask[..., None]
            t_db = kernel_ms(lambda: row_scatter_launch(flat, order, offsets, Bn * n,
                                                        edge_db=True), "edge_db_sum_kernel")
            db_sum = f"; under K6's name (edge_db_sum_kernel) device {t_db[0]:.4f} ms"
        p = plan_scatter(idx.shape[0] * n, C, rows.element_size(), flat.data_ptr() % 16 == 0,
                         sm_count(dev))
        got, again = fn().reshape(idx.shape[0], n, C), fn().reshape(idx.shape[0], n, C)
        ref = scatter_rows_plain(idx, src, n)
        torch.cuda.synchronize()
        e, ok = scatter_agree(got, again, ref)
        if not ok:
            raise AssertionError(f"the ordered scatter disagrees at {name}: {e}")
        keys = (idx.reshape(idx.shape[0], -1) + n * torch.arange(idx.shape[0], device=dev)[:, None])
        keys, src32 = keys.reshape(-1), src.reshape(-1, C).float()
        zeros = torch.zeros(idx.shape[0] * n, C, device=dev)
        t_k = kernel_ms(fn, DEVICE_NAMES["KS"])
        t_l = kernel_ms(lambda: torch.index_add(zeros, 0, keys, src32))
        t_p = call_ms(lambda: scatter_rows_plain(idx, src, n))
        t_r = kernel_ms(lambda: reverse_table(idx, n, mask))
        n_src = idx.numel() if mask is None else int(mask.sum())
        n_bytes = n_src * (C * rows.element_size() + 8) + 8 * (idx.shape[0] * n + 1) + nbytes(got)
        b = res.add(e, t_k, t_p, n_bytes, 0.0, t_l)
        print(f"KS ordered scatter {name}: idx {tuple(idx.shape)} rows {tuple(rows.shape)} "
              f"{rows.dtype} into {n}: max_abs_err {e:.3g} against index_add_ (tol {KS_TOL}), "
              f"a second call equal bit for bit; {p.route} route, {p.group} lanes a target "
              f"row, {p.rows_per_warp} rows a warp, {p.passes} pass(es), {p.threads} x "
              f"{p.grid} threads; device kernel {t_k[0]:.4f} ms library "
              f"(index_add) {t_l[0]:.4f} ms; call kernel {t_k[1]:.4f} ms library "
              f"{t_l[1]:.4f} ms; plain {t_p:.4f} ms; bound {b:.4f} ms; reverse table build "
              f"device {t_r[0]:.4f} ms call {t_r[1]:.4f} ms{db_sum}")
    print(f"KS over its {len(cases)} shapes: device kernel {res.device_ms:.4f} ms library "
          f"{res.library_device_ms:.4f} ms; call kernel {res.call_ms:.4f} ms library "
          f"{res.library_ms:.4f} ms")
    return res


def knn_composite(q, c, k, mask, values):
    """The library composite timed beside K2 and K4 as a yardstick (several
    PyTorch calls, not one, and never called by the port): the bf16 batched
    product, the mask, topk, and for K2 the advanced-indexing gather."""
    qb, cb = q.to(torch.bfloat16), c.to(torch.bfloat16)
    bsel = torch.arange(q.shape[0], device=q.device)[:, None, None]

    def run():
        score, idx = torch.bmm(qb, cb.mT).float().masked_fill_(~mask[:, None], NEG).topk(k)
        return (idx, score) if values is None else (idx, score, values[bsel, idx])
    return run


def knn_agree(q, c, k, mask, values):
    """One K2 (values given) or K4 call against knn_plain: (outputs, max score
    error, rows whose indices differ where the order is decided, decided
    rows, gather exact)."""
    out = knn_batched(q, c, k, mask, gather_values=values)
    idx, score = out[:2]
    ref_idx, ref_score = knn_plain(q, c, k + 1, mask)
    torch.cuda.synchronize()
    e = (score - ref_score[..., :k]).abs().max().item()
    # indices must agree wherever consecutive scores among the k+1 best are
    # separated by more than the tolerance (elsewhere the order is a tie)
    hi, lo = ref_score[..., :-1], ref_score[..., 1:]
    gaps = torch.where((hi < NEG / 2) & (lo < NEG / 2), torch.full_like(hi, float("inf")),
                       (hi - lo).abs())
    decided = gaps.min(-1).values > K2_TOL
    bad = (idx != ref_idx[..., :k]).any(-1) & decided
    bsel = torch.arange(q.shape[0], device=q.device)[:, None, None]
    gather_exact = values is None or torch.equal(out[2], values[bsel, idx])
    return out, e, bad, decided, gather_exact


def _knn_case(dev, res, name, q, c, k, mask, values):
    """K2 (values given) or K4 (values None) against knn_plain: scores within
    K2_TOL, indices equal wherever the order is decided, gather exact; its
    device and call ms beside the composite's.  Adds to `res` unless res is
    None."""
    out, e, bad, decided, gather_exact = knn_agree(q, c, k, mask, values)
    kernel = "K4" if values is None else "K2"
    t_k = kernel_ms(lambda: knn_batched(q, c, k, mask, gather_values=values),
                    DEVICE_NAMES[kernel])
    t_c = kernel_ms(knn_composite(q, c, k, mask, values))
    t_p = call_ms(lambda: knn_plain(q, c, k, mask, values))
    inputs = (q, c, mask) if values is None else (q, c, mask, values)
    flops = 2.0 * q.shape[0] * q.shape[1] * c.shape[1] * q.shape[2]
    cost = (nbytes(*inputs, *out), flops)
    b = bound(*cost)[0] if res is None else res.add(e, t_k, t_p, *cost, composite=t_c)
    cv = "" if values is None else f" Cv={values.shape[-1]}"
    print(f"{kernel} knn {name} q={tuple(q.shape)} c={tuple(c.shape)} k={k}{cv}: max_abs_err "
          f"{e:.3g} (tol {K2_TOL}), {int(bad.sum())} index rows differ of "
          f"{int(decided.sum())} decided, gather exact {gather_exact}; kernel device "
          f"{t_k[0]:.4f} ms call {t_k[1]:.4f} ms; composite device {t_c[0]:.4f} ms call "
          f"{t_c[1]:.4f} ms; plain {t_p:.4f} ms; bound {b:.4f} ms")
    if not (e <= K2_TOL and int(bad.sum()) == 0 and gather_exact):
        raise AssertionError(f"{kernel} disagrees with its plain version ({name})")


def knn_inputs(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    Bt = B_MESH * T
    vtx_f = l2_normalize(torch.randn(Bt, V_PAD, 64, device=dev, generator=g))
    pts_f = l2_normalize(torch.randn(Bt, P, 64, device=dev, generator=g))
    pts = torch.randn(Bt, P, 3, device=dev, generator=g)
    flow = torch.randn(Bt, V_PAD, 3, device=dev, generator=g)
    all_pts = torch.ones(Bt, P, dtype=torch.bool, device=dev)
    visible = torch.rand(Bt, V_PAD, device=dev, generator=g) < 0.4
    visible[0] = False                       # an all-masked batch row
    visible[1, 3:] = False                   # fewer than k valid candidates
    return vtx_f, pts_f, pts, flow, all_pts, visible


def check_k2(dev):
    """vismask 1-NN (Cv=64), voting against points (k=5, Cv=3), completion
    with query = cand and masked candidates (k=5, Cv=3): the kernel's row.
    Then the training step's vismask (B=4, N=2048, P=1024, k=1, Cv=64),
    printed apart so that the three-case sum stays comparable."""
    vtx_f, pts_f, pts, flow, all_pts, visible = knn_inputs(dev)
    res = Timings()
    for case in (("vismask", vtx_f, pts_f, 1, all_pts, pts_f),
                 ("voting", vtx_f, pts_f, 5, all_pts, pts),
                 ("completion", vtx_f, vtx_f, 5, visible, flow)):
        _knn_case(dev, res, *case)
    print(f"K2 over the three serving cases: device {res.device_ms:.4f} ms (the CUDA-core "
          f"kernel before the redesign: {K2_DEVICE_MS_BEFORE} ms), call {res.call_ms:.4f} ms; composite device "
          f"{res.composite_device_ms:.4f} ms call {res.composite_ms:.4f} ms")
    g = torch.Generator(device=dev).manual_seed(4)
    vtx = l2_normalize(torch.randn(TRAIN_B, 2048, 64, device=dev, generator=g))
    pts_t = l2_normalize(torch.randn(TRAIN_B, P, 64, device=dev, generator=g))
    ones = torch.ones(TRAIN_B, P, dtype=torch.bool, device=dev)
    _knn_case(dev, None, "training vismask", vtx, pts_t, 1, ones, pts_t)
    return res


def check_k4(dev):
    """K2's vismask (k=1) and voting (k=5) shapes without the gather."""
    vtx_f, pts_f, _, _, all_pts, _ = knn_inputs(dev)
    res = Timings()
    for case in (("vismask", vtx_f, pts_f, 1, all_pts, None),
                 ("voting", vtx_f, pts_f, 5, all_pts, None)):
        _knn_case(dev, res, *case)
    print(f"K4 over its two cases: device {res.device_ms:.4f} ms (the CUDA-core kernel "
          f"before the redesign: {K4_DEVICE_MS_BEFORE} ms), call {res.call_ms:.4f} ms; composite device "
          f"{res.composite_device_ms:.4f} ms call {res.composite_ms:.4f} ms")
    return res


_J = 48
K3_SHAPES = [(B_MESH * T, 1024, 3, 512 * 64), (B_MESH * T, 512, 67, 128 * 64),
             (B_MESH * T, 128, 131, 32 * 64), (B_MESH * T, 32, 256, 128 * 3),
             (B_MESH * T, 128, 128, 512 * 3), (B_MESH * T, 512, 64, 1024 * 3),
             (B_MESH, _J, 4, _J * _J), (B_MESH, _J, 131, _J // 3 * _J),
             (B_MESH, _J // 3, 256, _J * 3), (B_MESH, _J, 128, _J * 3), (B_MESH, _J, 3, _J * _J)]


def check_k3(dev):
    """Every (values, idx) shape of the main path, as (B, N, C, M); must be
    exact.  PointEncoder over the B*T clouds: sa1-3 grouping, fp3-1
    interpolation.  RootNet over 48 joint slots: sa1-2, fp2-1.  BoneNet's
    joint-set encoder: sa1-2.  Its library call is one advanced-indexing
    gather, values[bsel, idx]."""
    g = torch.Generator(device=dev).manual_seed(3)
    res = Timings()
    for Bn, N, C, M in K3_SHAPES:
        values = torch.randn(Bn, N, C, device=dev, generator=g)
        idx = torch.randint(0, N, (Bn, M), device=dev, generator=g)
        bsel = torch.arange(Bn, device=dev)[:, None]
        got, ref = gather_rows(values, idx), gather_plain(values, idx)
        exact = torch.equal(got, ref)
        t_k = kernel_ms(lambda: gather_rows(values, idx), DEVICE_NAMES["K3"])
        t_l = kernel_ms(lambda: values[bsel, idx])
        t_p = call_ms(lambda: gather_plain(values, idx))
        b = res.add(0.0, t_k, t_p, nbytes(values, idx, got), 0.0, t_l)
        print(f"K3 gather values=({Bn},{N},{C}) idx=({Bn},{M}): exact {exact}; device kernel "
              f"{t_k[0]:.4f} ms library {t_l[0]:.4f} ms; call kernel {t_k[1]:.4f} ms library "
              f"{t_l[1]:.4f} ms; plain {t_p:.4f} ms; bound {b:.4f} ms")
        if not exact:
            raise AssertionError(f"K3 is not exact at {(Bn, N, C, M)}")
    print(f"K3 over the {len(K3_SHAPES)} shapes: device kernel {res.device_ms:.4f} ms library "
          f"{res.library_device_ms:.4f} ms; call kernel {res.call_ms:.4f} ms library "
          f"{res.library_ms:.4f} ms")
    return res


# KG at the training step's shapes, (batch, M, K, N, bias): the Dense layers
# the split comparison named while they ran on cuBLAS (CorrNet's mesh encoder's
# vtx_gcu_4.mlp.dense_0 and the motion trunk's gcu_2.mlp.dense_0 over B=4 x
# V=2048 rows: KG's 128 x 128 tile; BoneNet's joint_encoder.sa3.nn.dense_4
# and RootNet's fp3.nn.dense_0 over 12 x 10 rows: split over K), a global MLP
# over the batch's rows (4 x 1088 -> 1024: split over K in the 8 x 128 tile)
# and the jointnet loss's masked mean (`dot_last`, 4 rows of 1024 products:
# split over K)
KG_SHAPES = ((None, 8192, 512, 512, True), (None, 8192, 288, 256, True),
             (None, 120, 256, 128, True), (None, 120, 768, 256, True),
             (None, 4, 1088, 1024, True), (4, 1, 1024, 1, False))
# the input gradients of the two 8192-row layers, dy @ W with W n-fast, (M, K,
# N): timed and checked beside KG_SHAPES, outside their sums
KG_N_FAST_SHAPES = ((8192, 512, 512), (8192, 256, 288))
KG_ULP = 2.0 ** -24


def kg_inputs(dev, batch, M, K, N, with_bias, n_fast, g):
    """a (batch, M, K); b a Dense weight's W^T view (k-fast) or, n_fast, dy @
    W's W (n-fast), scaled by 1/sqrt(K); the bias or None."""
    lead = () if batch is None else (batch,)
    a = torch.randn(lead + (M, K), device=dev, generator=g)
    if n_fast:
        b = torch.randn(lead + (K, N), device=dev, generator=g) / math.sqrt(K)
    else:
        b = (torch.randn(lead + (N, K), device=dev, generator=g) / math.sqrt(K)).transpose(-1, -2)
    bias = torch.randn(N, device=dev, generator=g) if with_bias else None
    return a, b, bias


def kg_holds(a, b, bias, got) -> dict:
    """KG's holds on one product: within the worst case of recursive
    summation of the float64 product; each half of the rows and each half of
    the columns (b's and the bias's) equal to the whole call's bit for bit;
    every route and tile `plan` can be forced to equal the planned call bit
    for bit (one thread per element only where a matrix has at most 2^16
    elements)."""
    from morig_tpu_torch.kernels import gemm as kg

    K, M, N = a.shape[-1], a.shape[-2], b.shape[-1]
    r64 = torch.matmul(a.double(), b.double())
    lim = torch.matmul(a.double().abs(), b.double().abs())
    if bias is not None:
        r64, lim = r64 + bias.double(), lim + bias.double().abs()
    close = bool(((got.double() - r64).abs() <= (K + 1) * KG_ULP * lim).all())
    h, w = M // 2, N // 2
    rows = h == 0 or all(torch.equal(gemm(a[..., part, :], b, bias), got[..., part, :])
                         for part in (slice(0, h), slice(h, M)))
    cols = w == 0 or all(torch.equal(gemm(a, b[..., part], None if bias is None else bias[part]),
                                     got[..., part]) for part in (slice(0, w), slice(w, N)))
    forced = [(route, tile) for route in kg.ROUTES
              for tile in ([None] if route == "tiny" else range(len(kg.TILES)))
              if route != "tiny" or M * N <= 1 << 16]
    routes = all(torch.equal(gemm(a, b, bias, route=r, tile=t), got) for r, t in forced)
    return {"bound": close, "rows": rows, "cols": cols, "routes": routes}


def check_kg(dev):
    """KG at KG_SHAPES (and KG_N_FAST_SHAPES, apart) against the float64
    product and itself (`kg_holds`).  max_abs_err is against the plain
    version; the library call is the plain version itself (one
    torch.matmul, cuBLAS), timed on the same inputs.  Bound: the products
    at the fp32 rate without tensor cores, or the bytes."""
    from morig_tpu_torch.kernels import gemm as kg

    g = torch.Generator(device=dev).manual_seed(21)
    res = Timings()
    cases = [(shape, False) for shape in KG_SHAPES] + [
        ((None, M, K, N, False), True) for M, K, N in KG_N_FAST_SHAPES]
    for (batch, M, K, N, with_bias), n_fast in cases:
        a, b, bias = kg_inputs(dev, batch, M, K, N, with_bias, n_fast, g)
        got, ref = gemm(a, b, bias), gemm_plain(a, b, bias)
        holds = kg_holds(a, b, bias, got)
        e = (got - ref).abs().max().item()
        t_k = kernel_ms(lambda: gemm(a, b, bias), DEVICE_NAMES["KG"])
        t_l = kernel_ms(lambda: gemm_plain(a, b, bias))
        t_p = call_ms(lambda: gemm_plain(a, b, bias))
        n = batch or 1
        n_bytes = nbytes(a, b, got) + (4 * N if with_bias else 0)
        if n_fast:
            bd = bound(n_bytes, 2.0 * M * N * K, FP32_FLOPS)[0]
        else:
            bd = res.add(e, t_k, t_p, n_bytes, 2.0 * n * M * N * K, t_l, peak=FP32_FLOPS)
        lead = () if batch is None else (batch,)
        p = kg.plan(n, M, N, K, kg.sm_count(dev))
        print(f"KG gemm {lead + (M, K)} x {lead + (K, N)}{' + bias' if with_bias else ''}"
              f"{' (b n-fast, outside the sums)' if n_fast else ''}: route {p.route} tile "
              f"{kg.TILES[p.tile] if p.tile >= 0 else None} splits {p.splits}; max_abs_err "
              f"{e:.3g} against torch.matmul; within the summation bound of the float64 product "
              f"{holds['bound']}; halves of the rows bit for bit {holds['rows']}; halves of the "
              f"columns bit for bit {holds['cols']}; every forced route and tile bit for bit "
              f"{holds['routes']}; device kernel {t_k[0]:.4f} ms library (torch.matmul) "
              f"{t_l[0]:.4f} ms (x{t_k[0] / t_l[0]:.2f}); call kernel {t_k[1]:.4f} ms library "
              f"{t_l[1]:.4f} ms; plain {t_p:.4f} ms; bound {bd:.4f} ms")
        if not all(holds.values()):
            raise AssertionError(f"KG disagrees at {(batch, M, K, N)}: {holds}")
    print(f"KG over the {len(KG_SHAPES)} shapes: device kernel {res.device_ms:.4f} ms library "
          f"{res.library_device_ms:.4f} ms; call kernel {res.call_ms:.4f} ms library "
          f"{res.library_ms:.4f} ms; bound {res.bound_ms:.4f} ms")
    return res


# ---------------------------------------------------------------------------
# phase 4: the two paths
# ---------------------------------------------------------------------------

def edge_launches(*nets) -> int:
    """One edge-kernel launch per EdgeMLP call of the networks' forwards:
    the motion trunks run once per keyframe."""
    return sum(T if "motionNet" in name else 1
               for net in nets for name, m in net.named_modules() if isinstance(m, EdgeMLP))


def expected_edge_launches(pred: RigPredictor) -> int:
    """One edge-kernel launch per EdgeMLP call (K1 on path 1, K5 on path 2)."""
    return edge_launches(pred.deform, pred.joint, pred.mask, pred.root, pred.bone, pred.skin)


# K2: vismask + voting + completion in the one (B*T) DeformNet forward.
# K3: PointEncoder sa1-3 + fp3-1 (6), RootNet sa1-2 + fp2-1 (4), BoneNet's
# joint-set sa1-2 (2); the global FP stages broadcast and gather nothing.
EXPECTED_KNN_LAUNCHES = 3
EXPECTED_GATHER_LAUNCHES = 12


def check_rigs(rigs, entries):
    assert len(rigs) == B_MESH, len(rigs)
    for i, rig in enumerate(rigs):
        assert len(rig.pos) >= 1 and np.isfinite(rig.pos).all(), f"rig {i}: bad joints"
        n_valid = int(np.asarray(entries[i]["vert_mask"]).sum())
        assert rig.skins.shape == (n_valid, len(rig.pos)), (i, rig.skins.shape)
        if (rig.parents >= 0).any():                       # at least one bone
            err = np.abs(rig.skins.sum(1) - 1.0).max()
            assert err <= 1e-3, f"rig {i}: skin rows off 1 by {err}"


# Substrings of each kernel's device-op names (K6: its main kernel, its dW2
# kernel, the fixed-order sums and the ordered scatter of db_table it
# launches after them under a name of its own, `edge_db_sum_kernel`; KS: the
# ordered row scatter of `scatter_rows`, the port's own kernel); no name
# holds another's, and K6's time includes its db_table sum.
DEVICE_NAMES = {"K1": "edge_mlp_table_kernel", "K2": "knn_wgmma_kernel", "K3": "gather_rows_kernel", "K4": "knn_wgmma_kernel",
                "K5": "edge_mlp_windowed_kernel",
                "K6": ("edge_mlp_bwd_kernel", "edge_mlp_dw2_kernel", "sum_parts_kernel",
                       "edge_db_sum_kernel"),
                "KS": "row_scatter_kernel", "KG": "gemm_f32_"}
COUNTERS = {"K1": fused_edge_mlp, "K2": knn_batched, "K3": gather_rows, "K4": knn_topk, "K5": fused_edge_mlp_windowed,
            "K6": fused_edge_mlp_bwd, "KS": scatter_rows, "KG": gemm}


def zero_counts() -> None:
    for c in COUNTERS.values():
        c.launches = 0


def read_counts() -> dict:
    return {k: c.launches for k, c in COUNTERS.items()}


def same_counts(launches: dict, expected: dict) -> bool:
    """launches equal expected, a kernel that `expected` leaves out expected
    to launch 0 times; but KG, the row-invariant product that every fp32
    Dense and the masked means launch, only where `expected` names it, and
    there at least that many times."""
    return (all(launches.get(k, 0) == expected.get(k, 0)
                for k in (set(launches) | set(expected)) - {"KG"})
            and launches.get("KG", 0) >= expected.get("KG", 0))


def time_path(name: str, pred: RigPredictor, entries, frames, **kw):
    """MAIN_REPS timed calls of predict_rig_batch, each checked.  The kernel
    counts are zeroed just before the first call and read just after it;
    returns them by kernel."""
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    walls, phases, launches = [], {}, None
    for _ in range(MAIN_REPS):
        timings: dict = {}
        t0 = time.perf_counter()
        rigs = pred.predict_rig_batch(entries, frames, timings=timings, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if launches is None:
            launches = read_counts()
        check_rigs(rigs, entries)
        for k, v in timings.items():
            phases.setdefault(k, []).append(v * 1e3)
    ms = np.asarray(walls) * 1e3
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    MEDIANS[name] = med
    print(f"{name}: {B_MESH} rigs, joints {[len(r.pos) for r in rigs]}; one call "
          f"median {med:.2f} ms (q1 {q1:.2f}, q3 {q3:.2f}, min {ms.min():.2f}, "
          f"max {ms.max():.2f}; {MAIN_REPS} calls): {B_MESH / med * 1e3:.3f} meshes/s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"{name} phase medians ms: "
          + ", ".join(f"{k} {np.median(v):.2f}" for k, v in phases.items()))
    return launches


def serve(name: str, pred: RigPredictor, entries, frames, expected: dict, **kw):
    """One warm-up call, then the timed calls; checks the launch counts of
    the first timed call against `expected`."""
    t0 = time.perf_counter()
    rigs = pred.predict_rig_batch(entries, frames, **kw)
    torch.cuda.synchronize()
    print(f"{name} warm-up: {time.perf_counter() - t0:.3f} s")
    check_rigs(rigs, entries)
    launches = time_path(name, pred, entries, frames, **kw)
    print(f"{name} kernel launches in the first timed call: {launches}, expected {expected}")
    if not same_counts(launches, expected):
        raise AssertionError(f"{name}: kernel launches {launches} != expected {expected}")
    return launches


# ---------------------------------------------------------------------------
# phase 5 (--profile only): where the time of one call goes
# ---------------------------------------------------------------------------

PROGRAMS = ("flow_joints", "skelnets", "skin_full")
KERNEL_NAMES = {k: DEVICE_NAMES[k] for k in ("K1", "K2", "K3", "K5")}
K5_PATH2_MS_BEFORE = 43.5   # K5's device ms per path-2 call before its redesign (PERF.md)
K1_PATH1_MS_BEFORE = 34.712  # K1's device ms per path-1 call before its redesign (PERF.md)
K1_DEVICE_MS_BEFORE = 3.3017  # K1's phase-3 five-width device ms before its redesign (PERF.md)
K2_DEVICE_MS_BEFORE = 0.9375  # K2's phase-3 three-case device ms before its redesign (PERF.md)
K4_DEVICE_MS_BEFORE = 0.5933  # K4's phase-3 two-case device ms before its redesign (PERF.md)
K2_PATH_MS_BEFORE = {"path 1": 0.967, "path 2": 0.968}  # K2 per call before (PERF.md)
K6_DEVICE_MS_BEFORE = 0.7184  # K6's phase-3 four-width device ms with the atomic db_table (PERF.md)
K6_STEP_MS_BEFORE = 2.45     # K6's device ms per training step on the WMMA recompute (PERF.md)
# The training forward before it ran K1 (the WMMA kernel K6 recomputed; PERF.md): its
# phase-3 four-width device ms and its device ms per training step
TRAIN_FWD_DEVICE_MS_BEFORE, TRAIN_FWD_STEP_MS_BEFORE = 0.8237, 1.69


def device_events(prof):
    """The device ops a torch.profiler run recorded: CUDA events other than
    user annotations (ranges such as the optimizer's step, which span
    kernels rather than run any)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def profile_programs(path: str, pred: RigPredictor, entries, frames, **kw):
    """Each device program on the inputs the DAG gave it in one call: its
    CUDA-event median (device wall, launch gaps included) and, under
    torch.profiler, the kernels it launched, the device time they were busy,
    and the share of the three ported kernels."""
    from torch.profiler import ProfilerActivity, profile

    captured = {}
    for name in PROGRAMS:
        def record(*args, _fn=getattr(pred, name), _name=name):
            captured[_name] = args
            return _fn(*args)
        setattr(pred, name, record)
    try:
        pred.predict_rig_batch(entries, frames, **kw)
    finally:
        for name in PROGRAMS:
            delattr(pred, name)
    per_call: dict = {}
    for name in PROGRAMS:
        fn, args = getattr(pred, name), captured[name]
        wall = median_ms(lambda: fn(*args))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        dev = device_events(prof)
        busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        by_name: dict = {}
        for e in dev:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        ported = []
        for k, sub in KERNEL_NAMES.items():
            n = sum(sub in e.name for e in dev)
            t = sum(v for op, v in by_name.items() if sub in op)
            per_call[k] = per_call.get(k, 0.0) + t
            ported.append(f"{k} {n} launches {t:.2f} ms")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        idle = f"{1 - busy / wall:.3f}" if dev else "not measured (no device events)"
        print(f"profile {path} {name}: CUDA-event median {wall:.2f} ms; {len(dev)} device "
              f"ops, busy {busy:.2f} ms, idle share {idle}; " + "; ".join(ported))
        print(f"profile {path} {name} top device ops ms: "
              + "; ".join(f"{n[:60]} {t:.2f}" for n, t in top))
    print(f"profile {path}: ported kernels' device ms per call: "
          + ", ".join(f"{k} {t:.3f}" for k, t in per_call.items())
          + (f" (K5 before its redesign: {K5_PATH2_MS_BEFORE} ms)" if per_call.get("K5") else "")
          + (f" (K1 before its redesign: {K1_PATH1_MS_BEFORE} ms)" if per_call.get("K1") else "")
          + (f" (K2 before its redesign: {K2_PATH_MS_BEFORE[path]} ms)"
             if path in K2_PATH_MS_BEFORE else ""))


def profile_geometry(dev, entries, jc):
    """CUDA-event medians of FPS at the PointEncoder's three stages and of the
    clustering at the main path's shapes."""
    from morig_tpu_torch.geometry.clustering import select_and_cluster
    from morig_tpu_torch.kernels.neighbors import fps

    g = torch.Generator(device=dev).manual_seed(5)
    pts = torch.rand(B_MESH * T, P, 3, device=dev, generator=g)
    ones = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    for n_in, n_out in ((1024, 512), (512, 128), (128, 32)):
        t = median_ms(lambda: fps(pts[:, :n_in], n_out, ones[:, :n_in]))
        print(f"profile fps B={B_MESH * T} {n_in}->{n_out}: {t:.2f} ms")
    mesh = stack_meshes(entries, dev)
    shifted = mesh.verts + 0.05 * torch.randn(mesh.verts.shape, device=dev, generator=g)
    attn = torch.rand(mesh.vert_mask.shape, device=dev, generator=g)
    t = median_ms(lambda: select_and_cluster(
        shifted, attn, mesh.vert_mask, jc.bandwidth_quantile, jc.meanshift_max_iter,
        jc.attn_threshold, jc.bandwidth_sample_rows))
    print(f"profile select_and_cluster B={B_MESH} 2V={2 * V_PAD}: {t:.2f} ms")


SHIFT_SCALE = 0.1


def phase_a_predictor(seed: int = 0) -> RigPredictor:
    """`RigPredictor.random(seed)` with JointNet's output layer scaled by
    SHIFT_SCALE.  A random head moves vertices by tanh of O(1) values, up to
    a unit, far out of the capsule (radius 0.12): with voxel containment no
    shifted point is then inside, every mesh falls back to one joint and the
    skeleton and skin stages run on one bone.  Scaled, the shifts are of the
    capsule's size, as a trained JointNet's (which moves vertices toward
    the skeleton inside the mesh) are, and the meshes get over ten joints."""
    pred = RigPredictor.random(seed)               # on the card
    with torch.no_grad():
        for p in pred.joint.jointnet.mlp_transform.out.parameters():
            p.mul_(SHIFT_SCALE)
    return pred


def phase_a_inputs(entries):
    """bench.py phase A's per-mesh preprocessing, once before timing: the
    capsule's 88^3 voxel grid and its surface-geodesic matrix."""
    cap = make_capsule_rig(37, 36)
    t0 = time.perf_counter()
    vox = voxelize_mesh(cap.verts, cap.faces, dims=VOX_DIMS)
    t1 = time.perf_counter()
    sg = surface_geodesic(cap.verts, cap.faces)
    t2 = time.perf_counter()
    impl = auto_select_edge_impl(entries, tile_v=EDGE_TILE)
    print(f"path 2 inputs: {VOX_DIMS}^3 grid ({int(vox.data.sum())} cells inside) in "
          f"{t1 - t0:.2f} s, surface geodesics {sg.shape} in {t2 - t1:.2f} s; edge dispatch "
          f"at tile {EDGE_TILE}: {impl}")
    if impl != "windowed":
        raise AssertionError(f"path 2 needs the windowed dispatch, got {impl}")
    return dict(voxes=[vox] * len(entries), surf_geos=[sg] * len(entries),
                edge_tile=EDGE_TILE)


# ---------------------------------------------------------------------------
# phase 6: training CorrNet (CorrPoseStage)
# ---------------------------------------------------------------------------

# K1 and K6: the mesh encoder's 8 edge layers (4 GCUs x tpl/geo), forward
# and backward; K2: the vismask 1-NN; K3: infoNCE's two anchor-row gathers
# (PointNet++'s training gathers index plainly); KS: the backward of K2's
# two gathers and of infoNCE's two.
EXPECTED_TRAIN = {"K1": 8, "K2": 1, "K3": 2, "K4": 0, "K5": 0, "K6": 8, "KS": 4}


def train_dataset(edge_tile=None) -> PoseDataset:
    """bench_train's corr stage data: 4 capsules (n_lat=37, n_lon=36, V=1298
    padded to the 2048 bucket, degree-12 tables, P=1024 points, 4 frames);
    with `edge_tile`, the dataset's option (phase 17)."""
    ds = capsule_pose_dataset(num_models=TRAIN_B, num_frames=4, num_points=P, n_lat=37,
                              n_lon=36)
    return PoseDataset(ds.models, tpl_max_degree=DEGREE, geo_max_degree=DEGREE,
                       edge_tile=edge_tile)


def train_batch(edge_tile=None):
    """`train_dataset`'s four capsules at frame pair (0, 2), on the card.
    Returns (batch, the entries' mesh tables)."""
    ds = train_dataset(edge_tile)
    return ds.batch(list(range(TRAIN_B)), 0, 2), ds._mesh_cache


def param_snapshot(model):
    return [p.detach().clone() for p in model.parameters()]


def train(batch, dev, profile_phase: bool):
    """One warm-up step and TRAIN_STEPS timed steps of CorrPoseStage on one
    batch, each checked; the kernel counts of the first timed step must be
    EXPECTED_TRAIN.  Returns them."""
    stage = CorrPoseStage()
    stage.train_vismask = True
    state = stage.init_state(0)                     # on the card
    gen = torch.Generator(device=dev).manual_seed(1)
    Bn, V, D = batch.mesh.tpl_nbr.shape
    print(f"train: CorrNet {sum(p.numel() for p in state.model.parameters())} parameters; "
          f"batch B={Bn} V={V} P={batch.points.pts.shape[1]} D={D}")
    t0 = time.perf_counter()
    losses = [stage.train_step(state, batch, gen)["total_loss"]]
    torch.cuda.synchronize()
    print(f"train warm-up step: {time.perf_counter() - t0:.3f} s, total_loss {losses[0]:.6f}")
    torch.cuda.reset_peak_memory_stats()
    walls, launches = [], None
    for _ in range(TRAIN_STEPS):
        before = param_snapshot(state.model)
        zero_counts()
        t0 = time.perf_counter()
        m = stage.train_step(state, batch, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if launches is None:
            launches = read_counts()
        moved = any(not torch.equal(a, p) for a, p in zip(before, state.model.parameters()))
        if not (math.isfinite(m["total_loss"]) and math.isfinite(m["grad_norm"]) and moved):
            raise AssertionError(f"train step: loss {m['total_loss']}, grad norm "
                                 f"{m['grad_norm']}, parameters moved {moved}")
        losses.append(m["total_loss"])
    ms = np.asarray(walls) * 1e3
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    MEDIANS["train"] = med
    print(f"train: step median {med:.2f} ms (q1 {q1:.2f}, q3 {q3:.2f}, min {ms.min():.2f}, "
          f"max {ms.max():.2f}; {TRAIN_STEPS} steps): {1e3 / med:.3f} steps/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; total_loss first "
          f"{losses[0]:.6f} last {losses[-1]:.6f} (all {[round(x, 5) for x in losses]}); "
          f"last grad norm {m['grad_norm']:.4f}")
    print(f"train kernel launches in the first timed step: {launches}, expected {EXPECTED_TRAIN}")
    if not same_counts(launches, EXPECTED_TRAIN):
        raise AssertionError(f"train: kernel launches {launches} != expected {EXPECTED_TRAIN}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    ev = stage.eval_step(state, batch)
    print(f"train eval_step: {ev}")
    if not all(math.isfinite(v) for v in ev.values()):
        raise AssertionError(f"eval_step: {ev}")
    if profile_phase:
        profile_step("train", stage, state, batch, gen)
    return launches, state


def profile_step(name, stage, state, batch, gen):
    """One training step under torch.profiler: its device ops, busy time and
    idle share against its CUDA-event time, and K1's, K6's and K2's device
    time."""
    from torch.profiler import ProfilerActivity, profile

    wall = median_ms(lambda: stage.train_step(state, batch, gen))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stage.train_step(state, batch, gen)
        torch.cuda.synchronize()
    dev = device_events(prof)
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    ported = []
    before = {"K1": f" (the training forward before it ran K1: {TRAIN_FWD_STEP_MS_BEFORE} ms)",
              "K6": f" (on the WMMA recompute: {K6_STEP_MS_BEFORE} ms)"} if name == "train" else {}
    for k in ("K1", "K6", "K2"):
        subs = DEVICE_NAMES[k] if isinstance(DEVICE_NAMES[k], tuple) else (DEVICE_NAMES[k],)
        n = sum(subs[0] in e.name for e in dev)
        t = sum(v for op, v in by_name.items() if any(sub in op for sub in subs))
        ported.append(f"{k} {n} launches {t:.2f} ms" + before.get(k, ""))
    idle = f"{1 - busy / wall:.3f}" if dev else "not measured (no device events)"
    print(f"profile {name} step: CUDA-event median {wall:.2f} ms; {len(dev)} device ops, busy "
          f"{busy:.2f} ms, idle share {idle}; " + "; ".join(ported))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile {name} step top device ops ms: "
          + "; ".join(f"{n[:60]} {t:.2f}" for n, t in top))


# ---------------------------------------------------------------------------
# the kernels at the shapes phases 7 and 8 give them
# ---------------------------------------------------------------------------

class Recorder:
    """A kernel wrapper standing in for `fn` where it is looked up: records in
    `calls` the arguments of its first call of each shape, then calls it.
    Its `launches` is fn's, since a wrapper counts on the name its own
    module looks it up by, which may be this one."""

    def __init__(self, fn, kernel: str, calls: dict):
        self.fn, self.kernel, self.calls = fn, kernel, calls

    def __call__(self, *args, **kw):
        key = (self.kernel,) + tuple(tuple(a.shape) if torch.is_tensor(a) else a for a in args) \
            + tuple((k, tuple(v.shape)) for k, v in kw.items() if torch.is_tensor(v))
        self.calls.setdefault(key, (self.kernel, args, kw))
        return self.fn(*args, **kw)

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.launches = n


@contextlib.contextmanager
def recording_kernel_calls(calls: dict):
    """Record in `calls` the arguments of the first K1, K2, K3 and ordered
    scatter (KS) call of each shape the networks make inside, by wrapping
    the wrappers where the networks look them up (K3 and KS also where the
    training gathers of the losses and K2's backward look them up)."""
    sites = ((gcu, "fused_edge_mlp", "K1"), (corrnet, "knn_batched", "K2"),
             (deformnet, "knn_batched", "K2"), (pointnet, "gather_rows", "K3"),
             (nbk, "gather_rows", "K3"), (gather_fused, "gather_rows", "K3"),
             (gather_fused, "scatter_rows", "KS"), (knn_fused, "scatter_rows", "KS"))
    originals = [getattr(mod, name) for mod, name, _ in sites]
    for (mod, name, kernel), fn in zip(sites, originals):
        setattr(mod, name, Recorder(fn, kernel, calls))
    try:
        yield calls
    finally:
        for (mod, name, _), fn in zip(sites, originals):
            setattr(mod, name, fn)


def check_recorded(phase: str, calls: dict) -> None:
    """Each recorded call's kernel against its plain version on the same
    inputs: K1 within K1_TOL / K1_MEAN_TOL, K2's scores within K2_TOL with
    the decided indices equal and the gather exact, K3 exact, KS within
    KS_TOL of `index_add_` and equal to itself run again."""
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "KS": 0.0}
    for kernel, args, kw in calls.values():
        if kernel == "K1":
            got, ref = fused_edge_mlp(*args), edge_mlp_plain(*args)
            e, e_mean = (got - ref).abs().max().item(), (got - ref).abs().mean().item()
            ok = e <= K1_TOL and e_mean <= K1_MEAN_TOL
        elif kernel == "K2":              # knn_batched(q, c, k, mask, gather_values=v)
            _, e, bad, _, exact = knn_agree(*args, kw["gather_values"])
            ok = e <= K2_TOL and int(bad.sum()) == 0 and exact
        elif kernel == "KS":
            e, ok = scatter_agree(scatter_rows(*args, **kw), scatter_rows(*args, **kw),
                                  scatter_rows_plain(*args))
        else:
            e = 0.0 if torch.equal(gather_rows(*args), gather_plain(*args)) else math.inf
            ok = e == 0.0
        worst[kernel] = max(worst[kernel], e)
        if not ok:
            shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
            raise AssertionError(f"{phase}: {kernel} disagrees with its plain version at {shapes}")
    counts = {k: sum(v[0] == k for v in calls.values()) for k in worst}
    print(f"{phase}: kernels against their plain versions at the path's shapes: "
          + ", ".join(f"{k} {counts[k]} shapes, max_abs_err {worst[k]:.3g}" for k in worst))


# ---------------------------------------------------------------------------
# phases 9-11: the motion training stages
# ---------------------------------------------------------------------------

# Per step.  DeformPoseStage: K1 on all 20 edge layers (the frozen CorrNet's
# 8 run their forward too), K6 on GCNDeform's 12 (on all 20 with the
# extractor trained), K2 on the vismask 1-NN, the voting and the
# completion.  RigStage and SkinStage: 72 edge layers, the motion trunk's 12
# for each of the 5 keyframes and the head's 12, each through K1 and K6; no
# kNN; K3 and KS: the multi-positive infoNCE's gathers and their backward, 3
# in each of its 6 calls (the 5 keyframes and their aggregate).  With the
# extractor trained, the deform step's infoNCE gathers (K3 2) and the
# backward of its three kNN calls' gathers and of those (KS 8).  No edge
# layer of the three stages at full width takes the plain route
# (`plain_edge`).
EXPECTED_DEFORM = {"K1": 20, "K2": 3, "K3": 0, "K4": 0, "K5": 0, "K6": 12, "plain_edge": 0}
EXPECTED_DEFORM_EXTRACTOR = dict(EXPECTED_DEFORM, K6=20, K3=2, KS=8)
MOTION_NCE = 18
EXPECTED_MOTION = {"K1": 72, "K2": 0, "K3": MOTION_NCE, "K4": 0, "K5": 0, "K6": 72,
                   "KS": MOTION_NCE, "plain_edge": 0}
MOTION_STEPS = 6          # timed steps after the warm-up in phases 9-11


def zero_stage_counts() -> None:
    zero_counts()
    gcu.plain_edge.launches = 0


def read_stage_counts() -> dict:
    return dict(read_counts(), plain_edge=gcu.plain_edge.launches)


@contextlib.contextmanager
def recording_training_calls(calls: dict):
    """Record in `calls` the inputs of the first training edge call of each
    shape, by wrapping `fused_edge_mlp_trainable` where the edge layers look
    it up: its forward's (K1, or K5 with its tile: bf16 a and b as the
    autograd Function rounds them, the tables, the parameters as they were)
    and, for a call that takes a gradient, also the dout its backward (K6)
    receives."""
    original = gcu.fused_edge_mlp_trainable

    def call(a, b, nbr, mask, *params, **kw):
        out = original(a, b, nbr, mask, *params, **kw)
        tile_v = kw.get("tile_v")
        key = (tuple(a.shape), tuple(nbr.shape), tuple(params[0].shape))
        args = (a.detach().to(torch.bfloat16), b.detach().to(torch.bfloat16), nbr, mask,
                *(p.detach().clone() for p in params))
        fwd = "K5" if tile_v else "K1"
        calls.setdefault((fwd,) + key, [fwd, args, None, tile_v])
        if out.requires_grad and ("K6",) + key not in calls:
            entry = calls[("K6",) + key] = ["K6", args, None, tile_v]
            out.register_hook(lambda g, e=entry: e.__setitem__(2, g.detach().float().clone()))
        return out

    gcu.fused_edge_mlp_trainable = call
    try:
        yield calls
    finally:
        gcu.fused_edge_mlp_trainable = original


def check_recorded_training(phase: str, calls: dict) -> None:
    """Each recorded training call against the plain version on the same
    inputs: K1 and K5 within K1_TOL / K1_MEAN_TOL, K5 also equal bit for bit
    to the forward K6 recomputes (the max its route compares against: the
    windowed trainable's invariant), K6's gradients as `k6_agree` holds them
    (dout from the recorded backward)."""
    worst, shapes = {"K1": 0.0, "K5": 0.0, "K6": 0.0}, {"K1": [], "K5": [], "K6": []}
    for kernel, args, dout, tile in calls.values():
        where = f"{phase} a {tuple(args[0].shape)} nbr {tuple(args[2].shape)}"
        if kernel in ("K1", "K5"):
            if kernel == "K1":
                got, ref = fused_edge_mlp(*args), edge_mlp_plain(*args)
            else:
                got = fused_edge_mlp_windowed(*args, tile_v=tile)
                ref = edge_mlp_windowed_plain(*args, tile_v=tile)
                _, k6_fwd = fused_edge_mlp_bwd(*args, torch.zeros_like(got), return_forward=True)
                if not torch.equal(got, k6_fwd):
                    raise AssertionError(f"{where}: K5's output is not K6's recomputed forward")
            e, e_mean = (got - ref).abs().max().item(), (got - ref).abs().mean().item()
            if not (e <= K1_TOL and e_mean <= K1_MEAN_TOL):
                raise AssertionError(f"{where}: {kernel} disagrees with its plain version: "
                                     f"{e}, {e_mean}")
        else:
            if dout is None:
                raise AssertionError(f"{where}: no dout reached the recorded K6 call")
            e, _ = k6_agree(fused_edge_mlp_bwd(*args, dout), edge_mlp_bwd_plain(*args, dout), where)
        worst[kernel] = max(worst[kernel], e)
        shapes[kernel].append(f"H={args[0].shape[-1]}")
    print(f"{phase}: training kernels against their plain versions at the step's shapes (B, V, "
          f"D = {tuple(args[2].shape)}): " + "; ".join(
              f"{k} {len(v)} shapes ({', '.join(v)}), max_abs_err {worst[k]:.3g}"
              for k, v in shapes.items() if v)
          + ("; K5's output equals K6's recomputed forward bit for bit" if shapes["K5"] else ""))


def run_stage(name: str, stage, state, batch, expected: dict, eval_fn, dev,
              profile_phase: bool) -> dict:
    """One recorded warm-up step (each K1/K6 call shape held to its plain
    version), `eval_fn(state)` before and after MOTION_STEPS timed steps on
    the same batch, each checked (finite loss and gradient norm, the trained
    parameters moved); the kernel counts of the first timed step must be
    `expected` and the eval loss must fall.  Returns the counts."""
    gen = torch.Generator(device=dev).manual_seed(1)
    trained = [p for p in state.model.parameters() if p.requires_grad]
    n_frozen = sum(p.numel() for p in state.model.parameters() if not p.requires_grad)
    print(f"{name}: {type(state.model).__name__} {sum(p.numel() for p in trained)} trained "
          f"parameters ({n_frozen} frozen)")
    calls, kcalls = {}, {}
    t0 = time.perf_counter()
    with recording_training_calls(calls), recording_kernel_calls(kcalls):
        first = stage.train_step(state, batch, gen)
    torch.cuda.synchronize()
    print(f"{name} warm-up step: {time.perf_counter() - t0:.3f} s, total_loss "
          f"{first['total_loss']:.6f}")
    check_recorded_training(name, calls)
    if kcalls:
        check_recorded(name, kcalls)
    del calls, kcalls
    ev_before = eval_fn(state)
    torch.cuda.reset_peak_memory_stats()
    walls, launches, losses = [], None, []
    for _ in range(MOTION_STEPS):
        before = [p.detach().clone() for p in trained]
        zero_stage_counts()
        t0 = time.perf_counter()
        m = stage.train_step(state, batch, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if launches is None:
            launches = read_stage_counts()
        moved = any(not torch.equal(a, p) for a, p in zip(before, trained))
        if not (all(math.isfinite(v) for v in m.values()) and moved):
            raise AssertionError(f"{name} step: {m}, trained parameters moved {moved}")
        losses.append(m["total_loss"])
    ev_after = eval_fn(state)
    ms = np.asarray(walls) * 1e3
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    MEDIANS[name] = med
    print(f"{name}: step median {med:.2f} ms (q1 {q1:.2f}, q3 {q3:.2f}, min {ms.min():.2f}, "
          f"max {ms.max():.2f}; {MOTION_STEPS} steps): {1e3 / med:.3f} steps/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; last step's losses "
          + ", ".join(f"{k} {v:.6f}" for k, v in m.items() if k != "grad_norm")
          + f"; total_loss by step {[round(x, 5) for x in losses]}; last grad norm "
          f"{m['grad_norm']:.4f}")
    print(f"{name} eval_step (fixed draws) before the timed steps {ev_before['total_loss']:.6f}, "
          f"after {ev_after['total_loss']:.6f}")
    print(f"{name} kernel launches in the first timed step: {launches}, expected {expected}")
    if not same_counts(launches, expected):
        raise AssertionError(f"{name}: kernel launches {launches} != expected {expected}")
    if not ev_after["total_loss"] < ev_before["total_loss"]:
        raise AssertionError(f"{name}: the eval loss did not fall: {ev_before} -> {ev_after}")
    if profile_phase:
        profile_step(name, stage, state, batch, gen)
    return launches


def train_deform(batch, corr_state, dev, profile_phase: bool) -> dict:
    """Phase 9: DeformPoseStage on phase 6's batch, its extractor loaded from
    phase 6's final CorrNet (`init_extractor_from`) and frozen: the
    extractor must stay as loaded, bit for bit.  Then one step of a fresh
    stage that trains the extractor: K6 on all 20 edge layers, finite, the
    extractor moved.  Returns the kernel counts of both counted steps."""
    stage = DeformPoseStage()
    state = stage.init_extractor_from(stage.init_state(0), corr_state)
    loaded = param_snapshot(state.model.corr_extractor)
    launches = run_stage("deform", stage, state, batch, EXPECTED_DEFORM,
                         lambda st: stage.eval_step(st, batch), dev, profile_phase)
    same = all(torch.equal(a, p) for a, p in zip(loaded, state.model.corr_extractor.parameters()))
    print(f"deform: the frozen extractor equals the loaded CorrNet bit for bit: {same}")
    if not same:
        raise AssertionError("deform: the frozen extractor changed")
    stage = DeformPoseStage(train_extractor=True)
    state = stage.init_extractor_from(stage.init_state(0), corr_state)
    before = param_snapshot(state.model.corr_extractor)
    zero_stage_counts()
    t0 = time.perf_counter()
    m = stage.train_step(state, batch, torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    counts = read_stage_counts()
    moved = any(not torch.equal(a, p) for a, p in zip(before, state.model.corr_extractor.parameters()))
    print(f"deform with the extractor trained: one step {(time.perf_counter() - t0) * 1e3:.2f} ms, "
          f"{m}; extractor moved {moved}; launches {counts}, expected {EXPECTED_DEFORM_EXTRACTOR}")
    if not (all(math.isfinite(v) for v in m.values()) and moved
            and same_counts(counts, EXPECTED_DEFORM_EXTRACTOR)):
        raise AssertionError(f"deform with the extractor trained: {m}, {moved}, {counts}")
    return {k: launches[k] + counts[k] for k in launches}


def rig_batch(ds=None):
    """The rig and skin stages' input: `creature_rig_dataset(num_models=4,
    seed=0)` at its defaults (`cli.py train joints|mask|skin --data
    creature`; `ds` when given): about 1900 vertices padded to the 2048
    bucket, degree-16 tables, T=5 keyframes, up to 48 joints; all four in
    one batch (the CLI's default batch is 2)."""
    t0 = time.perf_counter()
    ds = ds if ds is not None else creature_rig_dataset(num_models=TRAIN_B, seed=0)
    batch = ds.batch(list(range(TRAIN_B)))
    print(f"rig data: {time.perf_counter() - t0:.2f} s for {TRAIN_B} creatures, V "
          f"{[len(m.verts) for m in ds.models]} padded to {ds.pad_verts}, joints "
          f"{[m.rig.num_joints for m in ds.models]}, degree {batch.mesh.tpl_nbr.shape[-1]}, "
          f"flow {tuple(batch.gt_flow.shape)}")
    return batch


def full_width_state(name: str, stage):
    """`stage.init_state(0)` on the card, every edge layer on the kernel
    route."""
    state = stage.init_state(0)
    edges = [m for m in state.model.modules() if isinstance(m, EdgeMLP)]
    if not all(m.kernel_route for m in edges):
        raise AssertionError(f"{name}: an edge layer at full width is off the kernel route")
    return state


def motion_eval(stage, batch, dev):
    return lambda st: stage.eval_step(st, batch, torch.Generator(device=dev).manual_seed(5))


def train_motion(name: str, stage, batch, dev, profile_phase: bool) -> dict:
    """Phases 10-11: a RigStage or SkinStage at full width from seeded
    weights on the rig batch."""
    state = full_width_state(name, stage)
    return run_stage(name, stage, state, batch, EXPECTED_MOTION, motion_eval(stage, batch, dev),
                     dev, profile_phase)


# ---------------------------------------------------------------------------
# phase 12: the skeleton stages; phase 13: the capsule demo
# ---------------------------------------------------------------------------

# Per step: the shape encoder's 6 edge layers (3 GCUs x tpl/geo) through K1
# and K6; the joint-set PointNet++ gathers by plain indexing in training.
# One eval_step: K1 6 and K3 on every SA grouping and kNN interpolation
# (BoneNet's joint-set sa1-2; RootNet's sa1-2 and fp2-1, fp3 broadcasting).
EXPECTED_SKEL = {"K1": 6, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 6, "plain_edge": 0}
EXPECTED_SKEL_EVAL = {"bone": dict(EXPECTED_SKEL, K3=2, K6=0),
                      "root": dict(EXPECTED_SKEL, K3=4, K6=0)}
DEMO_STEPS, DEMO_CALLS = 12, 3


def skel_batch():
    """The bone and root stages' input: `creature_skel_dataset(num_models=4,
    seed=0)` at its defaults, on the card."""
    t0 = time.perf_counter()
    batch = creature_skel_dataset(num_models=TRAIN_B, seed=0)
    Bn, V, D = batch.mesh.tpl_nbr.shape
    print(f"skel data: {time.perf_counter() - t0:.2f} s; B={Bn} V={V} D={D}, valid vertices "
          f"{batch.mesh.vert_mask.sum(1).tolist()}, joints {batch.joints_mask.sum(1).tolist()} "
          f"of {batch.joints.shape[1]}, pairs P={batch.pairs.shape[1]}")
    return batch


def train_skel(name: str, stage, batch, dev, profile_phase: bool) -> dict:
    """Phase 12: a BoneStage or RootStage at full width from seeded weights
    on the skeleton batch, as phases 10-11, after one step that makes the
    zero-initialized head non-zero; then one counted `eval_step`, its K1 and
    K3 calls held against their plain versions.  Returns the counts of the
    first timed step plus the eval_step's."""
    state = full_width_state(name, stage)
    m = stage.train_step(state, batch, torch.Generator(device=dev).manual_seed(0))
    print(f"{name}: a first step to move the zero-initialized head: {m}")
    launches = run_stage(name, stage, state, batch, EXPECTED_SKEL,
                         lambda st: stage.eval_step(st, batch), dev, profile_phase)
    calls: dict = {}
    zero_stage_counts()
    with recording_kernel_calls(calls):
        ev = stage.eval_step(state, batch)
    counts = read_stage_counts()
    expected = EXPECTED_SKEL_EVAL[name]
    print(f"{name} eval_step: {ev}; launches {counts}, expected {expected}")
    if not (all(math.isfinite(v) for v in ev.values()) and same_counts(counts, expected)):
        raise AssertionError(f"{name} eval_step: {ev}, launches {counts} != {expected}")
    check_recorded(f"{name} eval_step", calls)
    return {k: launches[k] + counts[k] for k in launches}


def demo(dev) -> tuple[dict, RigPredictor, list]:
    """Phase 13: `capsule_predictor(train_steps=DEMO_STEPS)` on the card, then
    DEMO_CALLS `predict_rig` calls on each of its pose models with the points
    of frames 1-5, each checked, the kernel counts zeroed before each call
    and read after it; the first call's kernel calls on each capsule held
    against their plain versions.  Returns the counts summed over the
    calls, the predictor and its joint count on each capsule."""
    t0 = time.perf_counter()
    pred, pose_ds, rig_ds = capsule_predictor(train_steps=DEMO_STEPS)   # on the card
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    expected = {"K1": expected_edge_launches(pred), "K2": EXPECTED_KNN_LAUNCHES,
                "K3": EXPECTED_GATHER_LAUNCHES, "K4": 0, "K5": 0, "K6": 0}
    total = dict.fromkeys(COUNTERS, 0)
    walls, joints, calls = [], [], {}
    for i, model in enumerate(pose_ds.models):
        frames = np.stack([model.pts_traj[:, t, :] for t in range(1, 6)])
        entry = rig_ds._mesh_cache[i]
        n_valid = int(np.asarray(entry["vert_mask"]).sum())
        for rep in range(DEMO_CALLS):
            zero_counts()
            t0 = time.perf_counter()
            # the first call on each capsule records its kernel calls
            with recording_kernel_calls(calls if rep == 0 else {}):
                rig = pred.predict_rig(entry, frames)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = read_counts()
            check_rig(f"demo {model.name}", rig, n_valid, launches, expected)
            total = {k: total[k] + launches[k] for k in total}
        joints.append(len(rig.pos))
    check_recorded("demo", calls)
    ms = np.asarray(walls) * 1e3
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    print(f"demo: capsule_predictor(train_steps={DEMO_STEPS}) {train_s:.2f} s; predict_rig on "
          f"{len(pose_ds.models)} capsules (V padded to {rig_ds.pad_verts}) x {DEMO_CALLS} calls: "
          f"median {med:.2f} ms (q1 {q1:.2f}, q3 {q3:.2f}, min {ms.min():.2f}, max "
          f"{ms.max():.2f}); joints {joints}; launches per call {expected}")
    return total, pred, joints


def demo_joints(pred, pose_ds, rig_ds) -> list:
    """`predict_rig`'s joint count on each capsule of the demo (frames 1-5)."""
    return [len(pred.predict_rig(rig_ds._mesh_cache[i],
                                 np.stack([m.pts_traj[:, t, :] for t in range(1, 6)])).pos)
            for i, m in enumerate(pose_ds.models)]


# ---------------------------------------------------------------------------
# phase 14: the "batch" norm mode
# ---------------------------------------------------------------------------

# In "batch" norm mode no edge kernel runs: an EdgeMLP's BatchNorm tail is
# plain fp32 PyTorch, as in the JAX package, whose `_fusable` refuses the
# mode.  Per predict_rig_batch call K2 and K3 as on path 1; per CorrPoseStage
# step K2 on the vismask 1-NN, K3 and KS as in phase 6; per DeformPoseStage
# step K2 on the vismask, the voting and the completion; PointNet++'s
# training gathers by plain indexing.
EXPECTED_BATCH_SERVE = {"K1": 0, "K2": EXPECTED_KNN_LAUNCHES, "K3": EXPECTED_GATHER_LAUNCHES,
                        "K4": 0, "K5": 0, "K6": 0, "plain_edge": 0}
EXPECTED_BATCH_CORR = dict(EXPECTED_BATCH_SERVE, K2=1, K3=2, KS=4)
EXPECTED_BATCH_DEFORM = dict(EXPECTED_BATCH_SERVE, K3=0)
BATCH_CALLS, BATCH_STEPS = 5, 3     # timed calls and steps after the warm-up


@contextlib.contextmanager
def norm_mode(name: str):
    """Modules built inside are built in norm mode `name` (and keep it)."""
    prev = get_default_norm()
    set_default_norm(name)
    try:
        yield
    finally:
        set_default_norm(prev)


def buffer_snapshot(model):
    return [b.detach().clone() for b in model.buffers()]


def check_counts(name: str, launches: dict, expected: dict) -> None:
    if not same_counts(launches, expected):
        raise AssertionError(f"{name}: kernel launches {launches} != expected {expected}")


def median_line(ms) -> str:
    ms = np.asarray(ms)
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    return (f"median {med:.2f} ms (q1 {q1:.2f}, q3 {q3:.2f}, min {ms.min():.2f}, "
            f"max {ms.max():.2f}; {len(ms)} timed)")


def batch_norm_phase(entries, frames, batch, dev, profile_phase: bool) -> dict:
    """Phase 14: the six networks built in "batch" norm mode with seeded
    random weights and BatchNorm statistics (`RigPredictor.random`), served
    at path 1's configuration: one warm-up call whose K2 and K3 calls are
    held against their plain versions, then BATCH_CALLS timed calls, each
    checked, its counts zeroed before and read after it.  Then CorrPoseStage
    in that mode on phase 6's batch: a warm-up and BATCH_STEPS timed steps,
    finite, the parameters and the running statistics moved; and one
    DeformPoseStage step with the extractor loaded from that CorrNet and
    frozen: its parameters and running statistics must stay as loaded, bit
    for bit, and GCNDeform's must move.  With `profile_phase`, the serving
    call's device programs and one CorrPoseStage step under torch.profiler.
    Returns the counted launches."""
    with norm_mode("batch"):
        pred = RigPredictor.random(0, device=dev)
        corr_stage = CorrPoseStage()
        corr_state = corr_stage.init_state(0, device=dev)
        deform_stage = DeformPoseStage()
        deform_state = deform_stage.init_state(0, device=dev)
    corr_stage.train_vismask = True
    total = dict.fromkeys(read_stage_counts(), 0)

    def add(launches):
        for k in total:
            total[k] += launches[k]

    calls: dict = {}
    t0 = time.perf_counter()
    with recording_kernel_calls(calls):
        rigs = pred.predict_rig_batch(entries, frames)
    torch.cuda.synchronize()
    print(f"batch serve warm-up: {time.perf_counter() - t0:.3f} s")
    check_rigs(rigs, entries)
    check_recorded("batch serve", calls)
    del calls
    torch.cuda.reset_peak_memory_stats()
    walls, phases = [], {}
    for _ in range(BATCH_CALLS):
        timings: dict = {}
        zero_stage_counts()
        t0 = time.perf_counter()
        rigs = pred.predict_rig_batch(entries, frames, timings=timings)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        launches = read_stage_counts()
        check_rigs(rigs, entries)
        check_counts("batch serve", launches, EXPECTED_BATCH_SERVE)
        add(launches)
        for k, v in timings.items():
            phases.setdefault(k, []).append(v * 1e3)
    print(f"batch serve: {B_MESH} rigs, joints {[len(r.pos) for r in rigs]}; one call "
          f"{median_line(walls)}: {B_MESH / np.median(walls) * 1e3:.3f} meshes/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches per call "
          f"{EXPECTED_BATCH_SERVE}")
    print("batch serve phase medians ms: "
          + ", ".join(f"{k} {np.median(v):.2f}" for k, v in phases.items()))
    if profile_phase:
        profile_programs("batch serve", pred, entries, frames)
    del pred

    gen = torch.Generator(device=dev).manual_seed(1)
    model = corr_state.model
    t0 = time.perf_counter()
    first = corr_stage.train_step(corr_state, batch, gen)
    torch.cuda.synchronize()
    print(f"batch train warm-up step: {time.perf_counter() - t0:.3f} s, total_loss "
          f"{first['total_loss']:.6f}")
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(BATCH_STEPS):
        params, stats = param_snapshot(model), buffer_snapshot(model)
        zero_stage_counts()
        t0 = time.perf_counter()
        m = corr_stage.train_step(corr_state, batch, gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        launches = read_stage_counts()
        check_counts("batch train", launches, EXPECTED_BATCH_CORR)
        add(launches)
        moved = any(not torch.equal(a, p) for a, p in zip(params, model.parameters()))
        stats_moved = any(not torch.equal(a, b) for a, b in zip(stats, model.buffers()))
        if not (all(math.isfinite(v) for v in m.values()) and moved and stats_moved):
            raise AssertionError(f"batch train step: {m}, parameters moved {moved}, running "
                                 f"statistics moved {stats_moved}")
    print(f"batch train: CorrPoseStage step {median_line(walls)}: "
          f"{1e3 / np.median(walls):.3f} steps/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; last step {m}; launches per "
          f"step {EXPECTED_BATCH_CORR}")
    ev = corr_stage.eval_step(corr_state, batch)
    print(f"batch train eval_step (running statistics): {ev}")
    if not all(math.isfinite(v) for v in ev.values()):
        raise AssertionError(f"batch eval_step: {ev}")
    if profile_phase:
        profile_step("batch train", corr_stage, corr_state, batch, gen)

    deform_state = deform_stage.init_extractor_from(deform_state, corr_state)
    extractor, completing = deform_state.model.corr_extractor, deform_state.model.completing
    loaded = param_snapshot(extractor) + buffer_snapshot(extractor)
    stats = buffer_snapshot(completing)
    zero_stage_counts()
    t0 = time.perf_counter()
    m = deform_stage.train_step(deform_state, batch, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_stage_counts()
    check_counts("batch deform", launches, EXPECTED_BATCH_DEFORM)
    add(launches)
    same = all(torch.equal(a, b) for a, b in
               zip(loaded, list(extractor.parameters()) + list(extractor.buffers())))
    moved = any(not torch.equal(a, b) for a, b in zip(stats, completing.buffers()))
    print(f"batch deform: one DeformPoseStage step {ms:.2f} ms, {m}; the frozen extractor's "
          f"parameters and running statistics equal the loaded CorrNet's bit for bit: {same}; "
          f"GCNDeform's running statistics moved: {moved}; launches {launches}")
    if not (all(math.isfinite(v) for v in m.values()) and same and moved):
        raise AssertionError(f"batch deform: {m}, extractor unchanged {same}, GCNDeform's "
                             f"statistics moved {moved}")
    return total


# ---------------------------------------------------------------------------
# phase 16: repeatable training; phase 17: training through K5; phase 18:
# fp32 inference
# ---------------------------------------------------------------------------

REPRO_STEPS = 3           # steps after the seeded init, run twice
DEMO_NETS = ("joint", "mask", "bone", "root")


def repro_phase(dev, pose, rig, skel, demo_pred, demo_joint_counts) -> None:
    """Phase 16: each of the seven training steps (CorrPoseStage, DeformPoseStage,
    RigStage jointnet, SkinStage, BoneStage, RootStage at full width on
    phases 6, 10 and 12's batches, and CorrPoseStage in "batch" norm mode),
    a seeded init and REPRO_STEPS steps, run twice: every loss, gradient,
    parameter and running statistic must be equal bit for bit
    (`train.repro`).  Then `capsule_predictor` again: its joint count on
    each capsule and every parameter of its four trained networks must
    equal phase 13's.  Prints the first tensor that differs; any difference
    fails the run."""
    def corr():
        stage = CorrPoseStage()
        stage.train_vismask = True
        return stage

    differing = {}
    for name, make, batch, norm in (
            ("corr", corr, pose, "layer"), ("deform", DeformPoseStage, pose, "layer"),
            ("rig jointnet", lambda: RigStage(arch="jointnet"), rig, "layer"),
            ("skin", SkinStage, rig, "layer"), ("bone", BoneStage, skel, "layer"),
            ("root", RootStage, skel, "layer"), ("corr batch mode", corr, pose, "batch")):
        t0 = time.perf_counter()
        with norm_mode(norm):
            runs = [run_steps(make(), batch, REPRO_STEPS, device=dev) for _ in range(2)]
        first = first_difference(*runs)
        print(f"repro {name}: a seeded init and {REPRO_STEPS} steps, twice, {len(runs[0])} "
              f"tensors (losses, gradients, parameters, statistics) "
              + ("equal bit for bit" if first is None else f"differ, first: {first}")
              + f"; {time.perf_counter() - t0:.2f} s")
        if first is not None:
            differing[name] = first
        del runs
    pred, pose_ds, rig_ds = capsule_predictor(train_steps=DEMO_STEPS)
    joints = demo_joints(pred, pose_ds, rig_ds)
    for net in DEMO_NETS:
        first = next((n for (n, p), q in zip(getattr(demo_pred, net).named_parameters(),
                                              getattr(pred, net).parameters())
                      if not torch.equal(p, q)), None)
        if first is not None:
            differing[f"demo {net}"] = first
    print(f"repro demo: capsule_predictor(train_steps={DEMO_STEPS}) again: joints {joints} "
          f"(phase 13: {demo_joint_counts}); the {', '.join(DEMO_NETS)} networks' parameters "
          + ("equal bit for bit" if not any(k.startswith("demo") for k in differing)
             else "differ"))
    if joints != demo_joint_counts:
        differing["demo joints"] = f"{demo_joint_counts} then {joints}"
    if differing:
        raise AssertionError(f"repro: runs of one seed differ: {differing}")


# Per step through K5: every edge layer's forward K5 in place of K1, the rest
# as phases 6 and 10.
EXPECTED_TRAIN_K5 = dict(EXPECTED_TRAIN, K1=0, K5=EXPECTED_TRAIN["K1"], plain_edge=0)
EXPECTED_MOTION_K5 = dict(EXPECTED_MOTION, K1=0, K5=EXPECTED_MOTION["K1"])


def table_bandwidth(entries) -> list:
    """Per mesh entry, the farthest a valid neighbour lies from its vertex."""
    out = []
    for e in entries:
        v = np.arange(len(e["tpl_nbr"]))[:, None]
        out.append(int(max(np.abs(np.where(e[f"{k}_mask"], e[f"{k}_nbr"] - v, 0)).max()
                           for k in ("tpl", "geo"))))
    return out


ALTERNATE_ROUNDS = 6      # phase 17: rounds of timed steps in the order K5 K1 K1 K5


def alternate_steps(label: str, runs: dict, dev, card: str) -> None:
    """Phase 17's timing: the K5 and the K1 run of one stage, each with its
    stage, trained state and batch, take ALTERNATE_ROUNDS rounds of steps
    in the order K5 K1 K1 K5, so that neither route always steps first;
    their step medians side by side.  The two routes compute the same
    function on these tables, so their losses must stay equal step for
    step."""
    gens = {k: torch.Generator(device=dev).manual_seed(2) for k in runs}
    walls: dict = {k: [] for k in runs}
    losses: dict = {k: [] for k in runs}
    for _ in range(ALTERNATE_ROUNDS):
        for k in ("K5", "K1", "K1", "K5"):
            stage, state, batch = runs[k]
            t0 = time.perf_counter()
            m = stage.train_step(state, batch, gens[k])
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
            losses[k].append(m["total_loss"])
    q = {k: np.percentile(np.asarray(w) * 1e3, [25, 50, 75]) for k, w in walls.items()}
    for k in runs:
        MEDIANS[f"k5 training {label} alternating {k}"] = q[k][1]
    print(f"k5 training {label}: {ALTERNATE_ROUNDS} rounds of steps K5 K1 K1 K5 on the same "
          f"batch: step median through K5 {q['K5'][1]:.2f} ms (q1 {q['K5'][0]:.2f}, q3 "
          f"{q['K5'][2]:.2f}), through K1 {q['K1'][1]:.2f} ms (q1 {q['K1'][0]:.2f}, q3 "
          f"{q['K1'][2]:.2f}); K5/K1 {q['K5'][1] / q['K1'][1]:.3f}; losses equal step for "
          f"step: {losses['K5'] == losses['K1']}; {card}")
    if losses["K5"] != losses["K1"] or not all(map(math.isfinite, losses["K5"])):
        raise AssertionError(f"k5 training {label}: the K5 and K1 steps part: {losses}")


def k5_training(dev, profile_phase: bool) -> dict:
    """Phase 17: training through the windowed kernel, each stage as phase
    10 (`run_stage`: a recorded warm-up step whose K5 calls are held
    against their plain version and against K6's recomputed forward bit for
    bit, the eval loss before and after MOTION_STEPS timed steps, which
    must fall, the counts of the first): CorrPoseStage on phase 6's batch
    built with the dataset's edge_tile=EDGE_TILE, and RigStage jointnet on 4
    capsules at phase 6's size (V=1298 in 2048, the rig dataset's degree-16
    tables, T=5) with the dataset's edge_tile.  `auto_select_edge_impl`
    must say "windowed" for both.  (Phase 10's creatures are not local at
    the tile, also in RCM order: with the option they would train on K1.)
    Each stage then runs the same batch on the full table (K1) in the same
    way, and the two take alternating timed steps (`alternate_steps`).
    Returns the counts of the K5 steps."""
    card = gpu_name_power()
    corr_batch, corr_entries = train_batch(EDGE_TILE)
    capsules = capsule_rig_dataset(num_models=TRAIN_B, num_points=P, n_lat=37, n_lon=36)
    capsules.edge_tile = EDGE_TILE
    rig_b = capsules.batch(list(range(TRAIN_B)))
    impls = {"corr": auto_select_edge_impl(corr_entries, EDGE_TILE),
             "rig": auto_select_edge_impl(capsules._mesh_cache, EDGE_TILE)}
    print(f"k5 training: auto_select_edge_impl at tile {EDGE_TILE}: {impls}; table bandwidth "
          f"corr {table_bandwidth(corr_entries)}, rig {table_bandwidth(capsules._mesh_cache)}; "
          f"batch edge tiles corr {corr_batch.mesh.edge_tile}, rig {rig_b.mesh.edge_tile}; rig "
          f"batch V {rig_b.mesh.tpl_nbr.shape[1]} D {rig_b.mesh.tpl_nbr.shape[2]} flow "
          f"{tuple(rig_b.gt_flow.shape)}")
    if (impls["corr"], impls["rig"]) != ("windowed", "windowed") or \
            (corr_batch.mesh.edge_tile, rig_b.mesh.edge_tile) != (EDGE_TILE, EDGE_TILE):
        raise AssertionError(f"k5 training: the batches are not on the windowed kernel: {impls}")
    total = dict.fromkeys(read_stage_counts(), 0)

    def corr_stage():
        stage = CorrPoseStage()
        stage.train_vismask = True
        return stage

    for label, make, batch, expected in (
            ("corr", corr_stage, corr_batch, EXPECTED_TRAIN_K5),
            ("rig jointnet", lambda: RigStage(arch="jointnet"), rig_b, EXPECTED_MOTION_K5)):
        runs = {}
        for tile in (EDGE_TILE, None):
            route = "K5" if tile else "K1"
            name = f"k5 training {label} {route}"
            # on the full table K5's launches move to K1
            b, exp = (batch, expected) if tile else (
                dataclasses.replace(batch, mesh=dataclasses.replace(batch.mesh, edge_tile=None)),
                dict(expected, K1=expected["K5"], K5=0))
            stage = make()
            state = full_width_state(name, stage)
            ev = ((lambda st, stage=stage, b=b: stage.eval_step(st, b)) if label == "corr"
                  else motion_eval(stage, b, dev))
            launches = run_stage(name, stage, state, b, exp, ev, dev, profile_phase)
            if tile:
                total = {k: total[k] + launches.get(k, 0) for k in total}
            runs[route] = (stage, state, b)
        k5, k1 = MEDIANS[f"k5 training {label} K5"], MEDIANS[f"k5 training {label} K1"]
        print(f"k5 training {label}: step median through K5 {k5:.2f} ms, then through K1 "
              f"{k1:.2f} ms on the same batch (K5/K1 {k5 / k1:.3f}); {card}")
        alternate_steps(label, runs, dev, card)
        del runs
    return total


def f32_inference(pred, entries, frames, expected: dict) -> dict:
    """Phase 18: path 1 with `set_inference_dtype("f32")` (fp32 Dense layers
    at inference; the edge messages stay bf16): phase 4's checks of every
    call and its launch counts, and its call median beside path 1's (bf16)
    of phase 4.  The setting is put back to "auto" after."""
    set_inference_dtype("f32")
    try:
        launches = serve("path 1 f32", pred, entries, frames, expected)
    finally:
        set_inference_dtype("auto")
    f32, bf16 = MEDIANS["path 1 f32"], MEDIANS["path 1"]
    print(f"f32 inference: path 1 call median with fp32 Dense layers {f32:.2f} ms, with bf16 "
          f"{bf16:.2f} ms (f32/bf16 {f32 / bf16:.3f}); {gpu_name_power()}")
    return launches


# ---------------------------------------------------------------------------
# phase 15: the command line on dataset folders in the reference's layout
# ---------------------------------------------------------------------------

CLI_MODELS = 4            # creatures per dataset folder
CLI_STEP = 20             # modelsresource keyframes: 0, 20, ..., 100
CLI_PREDICT_STEPS = 2     # predict-rig --train-steps (phase 13 trains the demo for 12)
CLI_TRACK_FRAMES = 2      # track --frames: 1 tracked frame (phase 8 tracks 5)


def spread_frames(x: np.ndarray, step: int = CLI_STEP) -> np.ndarray:
    """(N, K, ...) keyframes -> (N, (K - 1) * step + 1, ...): keyframe k at
    frame k * step exactly, the frames between linearly interpolated."""
    K = x.shape[1]
    t = np.arange((K - 1) * step + 1) / step
    k0 = np.minimum(np.floor(t).astype(int), K - 2)
    w = (t - k0).reshape((1, -1) + (1,) * (x.ndim - 2))
    return (x[:, k0] * (1.0 - w) + x[:, k0 + 1] * w).astype(x.dtype)


@contextlib.contextmanager
def timed_calls(totals: dict, sites):
    """Add to totals[name] the wall seconds of every call of module.name for
    each (module, name) in `sites`, by wrapping the functions where their
    callers look them up."""
    originals = [getattr(mod, name) for mod, name in sites]

    def timed(fn, name):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                totals[name] = totals.get(name, 0.0) + time.perf_counter() - t0
        return call

    for (mod, name), fn in zip(sites, originals):
        setattr(mod, name, timed(fn, name))
    try:
        yield totals
    finally:
        for (mod, name), fn in zip(sites, originals):
            setattr(mod, name, fn)


PREPROCESS_STAGES = ((preprocess, "surface_geodesic"), (geodesic, "fps_numpy"),
                     (native, "geodesic_all_pairs"), (preprocess, "vertex_bone_geodesic"),
                     (preprocess, "voxelize_mesh"), (preprocess, "get_geo_edges"),
                     (preprocess, "get_tpl_edges"), (preprocess, "write_binvox"))
LOADER_STAGES = ((loaders, "build_rig_model"), (loaders, "load_edge_file"))


def write_cli_folders(root: str, dev) -> tuple[str, str]:
    """A pose folder and a rig folder in the reference's layout for
    `creature_pose_dataset` / `creature_rig_dataset(num_models=4, seed=0)`
    at their defaults: each creature's mesh written as OBJ and read back,
    its edge tables from `preprocess_model` (cache and .binvox under
    root/cache), 101-frame trajectories with the 6 frames at the
    modelsresource keyframes, the rig, attention and predicted flows.  Both
    folders are read back by the loaders and held to the datasets: pose
    fields bit for bit, rig flows bit for bit and the rig within the text
    format's rounding.  Returns (pose folder, rig folder)."""
    t0 = time.perf_counter()
    pose_ds = creature_pose_dataset(num_models=CLI_MODELS, seed=0)
    rig_ds = creature_rig_dataset(num_models=CLI_MODELS, seed=0)
    t_data = time.perf_counter() - t0
    pose_dir, rig_dir, cache = (os.path.join(root, d) for d in ("pose", "rig", "cache"))
    os.makedirs(pose_dir)
    os.makedirs(os.path.join(rig_dir, "pred_flow"))
    t_pre, attn, pre_stages, load_stages = [], {}, {}, {}
    for i, (pm, rm) in enumerate(zip(pose_ds.models, rig_ds.models)):
        c = make_creature_sequence(seed=i, num_frames=pm.num_frames)["rig"]   # the datasets' mesh
        name, obj = pm.name, os.path.join(root, f"{pm.name}.obj")
        write_obj(obj, c.verts, c.faces)
        verts, faces = read_obj(obj)
        t0 = time.perf_counter()
        with timed_calls(pre_stages, PREPROCESS_STAGES):
            pre = preprocess_model(verts, faces, rm.rig, cache_dir=cache, name=name, device=dev)
        t_pre.append(time.perf_counter() - t0)
        for folder in (pose_dir, rig_dir):
            np.savetxt(os.path.join(folder, f"{name}_tpl_e.txt"), pre["tpl_edges"], fmt="%d")
            np.savetxt(os.path.join(folder, f"{name}_geo_e.txt"), pre["geo_edges"], fmt="%d")
        p = os.path.join(pose_dir, name)
        for key in ("vtx_traj", "pts_traj", "vismask"):
            np.save(f"{p}_{key}.npy", spread_frames(getattr(pm, key)))
        for key in ("corr_v2p", "corr_p2v"):
            corr = getattr(pm, key).astype(np.int64)
            corr[:, -1] *= CLI_STEP
            np.save(f"{p}_{key}.npy", corr)
        r = os.path.join(rig_dir, name)
        np.save(f"{r}_vtx_traj.npy", spread_frames(pm.vtx_traj))
        rm.rig.save(f"{r}_rig.txt")
        np.savetxt(f"{r}_attn.txt", pre["attn"])
        attn[name] = pre["attn"]
        for t in range(rm.gt_flow.shape[1] // 3):
            np.save(os.path.join(rig_dir, "pred_flow", f"{name}_{t + 1}_pred_flow.npy"),
                    rm.pred_flow[:, 3 * t:3 * t + 3])
    t0 = time.perf_counter()
    with timed_calls(load_stages, LOADER_STAGES):
        poses, rigs = load_pose_models(pose_dir), load_rig_models(rig_dir)
    t_load = time.perf_counter() - t0
    for pm, lm in zip(pose_ds.models, poses, strict=True):
        for key in ("vtx_traj", "pts_traj", "vismask", "corr_v2p", "corr_p2v"):
            np.testing.assert_array_equal(getattr(lm, key), getattr(pm, key), err_msg=key)
    for rm, lm in zip(rig_ds.models, rigs, strict=True):
        for key in ("verts", "gt_flow", "pred_flow"):
            np.testing.assert_array_equal(getattr(lm, key), getattr(rm, key), err_msg=key)
        np.testing.assert_array_equal(lm.attn, attn[lm.name])
        np.testing.assert_allclose(lm.rig.pos, rm.rig.pos, rtol=0, atol=1e-8)
        np.testing.assert_allclose(lm.rig.skins, rm.rig.skins, rtol=0, atol=5e-5)
        if not (lm.rig.names == rm.rig.names and np.isfinite(lm.skin_input).all()):
            raise AssertionError(f"cli data: rig model {lm.name} read back wrong")
    print(f"cli data: {CLI_MODELS} creatures (V {[m.num_verts for m in poses]}, T "
          f"{[m.num_frames for m in poses]}, J {[m.rig.num_joints for m in rigs]}) in "
          f"{t_data:.2f} s; preprocess_model {[round(x, 2) for x in t_pre]} s (tpl / geo "
          f"edges, surface and volumetric geodesics, 88^3 voxels); both folders read back by "
          f"load_pose_models / load_rig_models in {t_load:.2f} s, equal to the datasets")
    print("cli data: preprocess_model's stages, s over the 4 creatures: "
          + ", ".join(f"{k} {v:.2f}" for k, v in pre_stages.items())
          + f" (fps_numpy and geodesic_all_pairs inside surface_geodesic); the loaders: "
          + ", ".join(f"{k} {v:.3f}" for k, v in load_stages.items())
          + f", the rest (np.load, the rig and attention files) "
          f"{t_load - sum(load_stages.values()):.3f}")
    return pose_dir, rig_dir


class Tee(io.StringIO):
    """Text written to it goes to `out` too."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, s):
        self.out.write(s)
        return super().write(s)


def stage_counts(**per) -> dict:
    return dict(dict.fromkeys(list(COUNTERS) + ["plain_edge"], 0), **per)


def run_cli(name: str, argv: list, expected: dict, dev) -> tuple[dict, str]:
    """`cli.main(argv + --device)` with the kernel counts zeroed before it and
    read after it (they must be `expected`), its first K1, K2, K3 (inference)
    and K1/K6 (training) call of each shape recorded and held against their
    plain versions.  Prints its wall seconds and peak memory; returns
    (launches, its standard output)."""
    calls, training = {}, {}
    out = Tee(sys.stdout)
    zero_stage_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording_kernel_calls(calls), recording_training_calls(training), \
            contextlib.redirect_stdout(out):
        cli.main(argv + ["--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_stage_counts()
    print(f"cli {name}: {wall:.2f} s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; launches {launches}, expected {expected}")
    check_counts(f"cli {name}", launches, expected)
    if calls:
        check_recorded(f"cli {name}", calls)
    if training:
        check_recorded_training(f"cli {name}", training)
    return launches, out.getvalue()


def check_finite_log(name: str, logdir: str) -> None:
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if not rows or not all(math.isfinite(v) for r in rows for k, v in r.items() if k != "split"):
        raise AssertionError(f"cli {name}: metrics {rows}")


def cli_phase(dev, edge: int) -> dict:
    """Phase 15: `morig_tpu_torch.cli.main` on the card in a temporary
    directory: the reference-layout folders (`write_cli_folders`), then
    train corr_pose -> train corr_pose --edge-impl windowed (on the capsule
    fixture, whose tables are local) -> train deform_pose --init-extractor
    (the extractor must equal the CorrNet bit for bit) -> eval deform ->
    train joints -> predict-rig --save-intermediates -> eval rig -> track
    -> eval tracking, each through `run_cli`, its outputs checked.  `edge`
    is K1's launches per predict_rig call.  Returns the launches summed
    over the commands."""
    corr_step = stage_counts(K1=8, K2=1, K6=8, K3=2, KS=4)
    corr_eval = stage_counts(K1=8, K2=1, K3=6)
    corr_windowed = {k: corr_step[k] + corr_eval[k] for k in corr_step}
    corr_windowed.update(K1=0, K5=corr_step["K1"] + corr_eval["K1"])
    deform_step, deform_eval = stage_counts(K1=20, K2=3, K6=12), stage_counts(K1=20, K2=3, K3=6)
    motion = EXPECTED_MOTION["K1"]
    capsule_step = 2 * motion + 2 * EXPECTED_SKEL["K1"]     # joint, mask, bone, root
    predict_calls = 2                                        # capsule_predictor's two capsules
    tracked = CLI_TRACK_FRAMES - 1

    def total(*parts):
        return {k: sum(p[k] for p in parts) for k in parts[0]}

    expected = {
        "train corr_pose": total(corr_step, corr_eval),
        "train corr_pose windowed": corr_windowed,
        "train deform_pose": total(deform_step, deform_eval),
        "eval deform": deform_eval,
        "train joints": stage_counts(K1=2 * motion + 2 * motion, K6=2 * motion,
                                     K3=2 * MOTION_NCE, KS=2 * MOTION_NCE),
        "predict-rig": stage_counts(K1=CLI_PREDICT_STEPS * capsule_step + predict_calls * edge,
                                    K6=CLI_PREDICT_STEPS * capsule_step,
                                    K2=predict_calls * EXPECTED_KNN_LAUNCHES,
                                    K3=(predict_calls * EXPECTED_GATHER_LAUNCHES
                                        + CLI_PREDICT_STEPS * 2 * MOTION_NCE),
                                    KS=CLI_PREDICT_STEPS * 2 * MOTION_NCE),
        "eval rig": stage_counts(),
        "track": stage_counts(K1=tracked * 20, K2=tracked * EXPECTED_KNN_LAUNCHES, K3=tracked * 6),
        "eval tracking": stage_counts(),
    }
    launches = []
    with tempfile.TemporaryDirectory() as root:
        pose_dir, rig_dir = write_cli_folders(root, dev)
        d = {k: os.path.join(root, k) for k in ("corr", "corr_windowed", "deform", "joints", "res",
                                                "gt", "track", "track_gt", "logs")}
        pose = ["--data", pose_dir, "--batch-size", str(CLI_MODELS), "--seed", "0"]

        def run(name, argv):
            n, text = run_cli(name, argv, expected[name], dev)
            launches.append(n)
            return text

        run("train corr_pose", ["train", "corr_pose", *pose, "--epochs", "1", "--train-vismask",
                                "--checkpoint", d["corr"], "--logdir", d["logs"] + "/corr"])
        check_finite_log("train corr_pose", d["logs"] + "/corr")
        run("train corr_pose windowed", ["train", "corr_pose", "--data", "capsule", "--epochs",
                                         "1", "--train-vismask", "--edge-impl", "windowed",
                                         "--checkpoint", d["corr_windowed"],
                                         "--logdir", d["logs"] + "/corr_windowed"])
        check_finite_log("train corr_pose windowed", d["logs"] + "/corr_windowed")
        run("train deform_pose", ["train", "deform_pose", *pose, "--epochs", "1",
                                  "--init-extractor", os.path.join(d["corr"], "model_best.pt"),
                                  "--checkpoint", d["deform"], "--logdir", d["logs"] + "/deform"])
        check_finite_log("train deform_pose", d["logs"] + "/deform")
        corr_sd = torch.load(os.path.join(d["corr"], "model_best.pt"), weights_only=True)["model"]
        deform_sd = torch.load(os.path.join(d["deform"], "checkpoint.pt"),
                               weights_only=True)["model"]
        same = all(torch.equal(deform_sd[f"corr_extractor.{k}"], v) for k, v in corr_sd.items())
        print(f"cli train deform_pose: the extractor equals the CorrNet bit for bit: {same}")
        if not same:
            raise AssertionError("cli train deform_pose: the extractor is not the CorrNet")
        text = run("eval deform", ["eval", "deform", *pose, "--resume",
                                   os.path.join(d["deform"], "model_best.pt")])
        err = float(text.split("mean flow L2:")[1].split()[0])
        if not math.isfinite(err):
            raise AssertionError(f"cli eval deform: {err}")
        run("train joints", ["train", "joints", "--data", rig_dir, "--epochs", "1",
                             "--checkpoint", d["joints"], "--logdir", d["logs"] + "/joints"])
        check_finite_log("train joints", d["logs"] + "/joints")
        run("predict-rig", ["predict-rig", "--out", d["res"], "--save-intermediates",
                            "--train-steps", str(CLI_PREDICT_STEPS)])
        os.makedirs(d["gt"])
        names = sorted(f[:-len("_gt_rig.txt")] for f in os.listdir(d["res"])
                       if f.endswith("_gt_rig.txt"))
        for name in names:
            for suffix in ("_rig.txt", "_shift.ply", "_attn.npy"):
                if not os.path.exists(os.path.join(d["res"], name + suffix)):
                    raise AssertionError(f"cli predict-rig: no {name}{suffix}")
            rig = sk.Rig.load(os.path.join(d["res"], f"{name}_rig.txt"))
            err = np.abs(rig.skins.sum(1) - 1.0).max()
            if not (np.isfinite(rig.pos).all() and err <= 1e-3):
                raise AssertionError(f"cli predict-rig {name}: joints finite "
                                     f"{np.isfinite(rig.pos).all()}, skin rows off 1 by {err}")
            shutil.copyfile(os.path.join(d["res"], f"{name}_gt_rig.txt"),
                            os.path.join(d["gt"], f"{name}_rig.txt"))
        if len(names) != predict_calls:
            raise AssertionError(f"cli predict-rig: rigs {names}")
        run("eval rig", ["eval", "rig", "--res", d["res"], "--gt", d["gt"]])
        ev = np.load(os.path.join(d["res"], "rig_eval.npz"))
        if not all(np.isfinite(ev[k]).all() for k in ev.files if k.startswith("mean_")):
            raise AssertionError(f"cli eval rig: {dict(ev)}")
        run("track", ["track", "--out", d["track"], "--frames", str(CLI_TRACK_FRAMES)])
        tr = np.load(os.path.join(d["track"], "capsule_tracking.npz"))
        norm = np.abs(np.linalg.norm(tr["pred_quats"], axis=-1) - 1.0).max()
        if not (all(np.isfinite(tr[k]).all() for k in tr.files) and norm <= 1e-4
                and os.path.exists(os.path.join(d["track"], "capsule_smooth_frame000.ply"))):
            raise AssertionError(f"cli track: keys {tr.files}, quaternion norms off 1 by {norm}")
        seq = make_capsule_sequence(num_frames=CLI_TRACK_FRAMES, num_points=256)
        os.makedirs(d["track_gt"])
        np.save(os.path.join(d["track_gt"], "capsule_vtx_traj.npy"), seq["vtx_traj"])
        np.save(os.path.join(d["track_gt"], "capsule_vismask.npy"), seq["vismask"])
        run("eval tracking", ["eval", "tracking", "--res", d["track"], "--gt", d["track_gt"]])
        fe = np.load(os.path.join(d["track"], "capsule_flow_errors.npz"))
        if not all(np.isfinite(fe[k]).all() for k in fe.files):
            raise AssertionError(f"cli eval tracking: {dict(fe)}")
    return {k: sum(n[k] for n in launches) for k in COUNTERS}


# ---------------------------------------------------------------------------
# phase 7: the single-mesh API
# ---------------------------------------------------------------------------

SINGLE_REPS = 5       # timed predict_rig calls after the warm-up


def check_rig(name: str, rig, n_valid: int, launches: dict, expected: dict) -> None:
    """One predict_rig result: finite joints, one skin row per valid vertex
    summing to 1 within 1e-3, and the call's kernel counts as expected."""
    err = np.abs(rig.skins.sum(1) - 1.0).max()
    if not (len(rig.pos) >= 1 and np.isfinite(rig.pos).all()
            and rig.skins.shape == (n_valid, len(rig.pos)) and err <= 1e-3
            and same_counts(launches, expected)):
        raise AssertionError(f"{name}: joints finite {np.isfinite(rig.pos).all()}, skins "
                             f"{rig.skins.shape}, rows off 1 by {err}, launches {launches} "
                             f"(expected {expected})")


def single_mesh(pred: RigPredictor, entry: dict, frames: np.ndarray, expected: dict) -> dict:
    """predict_rig on one capsule request: a warm-up call (its kernel calls
    recorded and checked against the plain versions), then SINGLE_REPS
    timed calls, each checked, with the kernel counts zeroed before each
    and read after it.  Returns the first timed call's counts."""
    calls: dict = {}
    t0 = time.perf_counter()
    with recording_kernel_calls(calls):
        rig = pred.predict_rig(entry, frames)
    torch.cuda.synchronize()
    print(f"single mesh warm-up: {time.perf_counter() - t0:.3f} s")
    check_recorded("single mesh", calls)
    n_valid = int(np.asarray(entry["vert_mask"]).sum())
    walls, stages, first = [], {}, None
    torch.cuda.reset_peak_memory_stats()
    for _ in range(SINGLE_REPS):
        timings: dict = {}
        zero_counts()
        t0 = time.perf_counter()
        rig = pred.predict_rig(entry, frames, timings=timings)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = read_counts()
        first = first or launches
        check_rig("single mesh", rig, n_valid, launches, expected)
        for k, v in timings.items():
            stages.setdefault(k, []).append(v * 1e3)
    batch_rig = pred.predict_rig_batch([entry], [frames])[0]
    ms = np.asarray(walls) * 1e3
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    print(f"single mesh: predict_rig V={entry['verts'].shape[0]} ({n_valid} valid) "
          f"P={frames.shape[1]} T={frames.shape[0]}: median {med:.2f} ms (q1 {q1:.2f}, q3 "
          f"{q3:.2f}, min {ms.min():.2f}, max {ms.max():.2f}; {SINGLE_REPS} calls); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {len(rig.pos)} joints "
          f"(predict_rig_batch on the same mesh: {len(batch_rig.pos)})")
    print("single mesh stage medians ms: "
          + ", ".join(f"{k} {np.median(v):.2f}" for k, v in stages.items()))
    print(f"single mesh kernel launches per call: {first}, expected {expected}")
    return first


# ---------------------------------------------------------------------------
# phase 8: tracking
# ---------------------------------------------------------------------------

TRACK_FRAMES = 6          # frames per sequence: frame 0 is the rest pose, 5 are tracked
TRACK_P, TRACK_PAD = 256, 1024                       # `cli.py track`'s cloud and bucket
CREATURES, CREATURE_P, CREATURE_VERTS, CREATURE_RES = 4, 512, 900, 40   # bench.py phase B2
CREATURE_DEGREE = 12
IK_HALF = ("ik1", "gate", "ik2")


def tracking_inputs():
    """The capsule sequence at `cli.py track`'s size (V=274 padded to 1024,
    degree-16 tables, P=256) and NB=4 creatures at bench.py phase B2's
    configuration (seeds 100-103, P=512, at most 900 vertices at res 40,
    the 1024 bucket, degree-12 tables, the joint axis rounded up to a
    multiple of 8), each with TRACK_FRAMES frames in place of B2's 21."""
    seq = make_capsule_sequence(num_frames=TRACK_FRAMES, num_points=TRACK_P)
    cap = seq["rig"]
    single = dict(rig=sk.Rig(names=list(cap.names), pos=cap.joints.astype(float),
                             parents=cap.parents, skins=cap.skins),
                  entry=build_mesh(cap.verts, seq["tpl_edges"], seq["geo_edges"], TRACK_PAD),
                  vtx0=cap.verts, pts=seq["pts_traj"])
    rigs, entries, vtx0, pts, jm = [], [], [], [], 8
    for i in range(CREATURES):
        cs = make_creature_sequence(seed=100 + i, num_frames=TRACK_FRAMES, num_points=CREATURE_P,
                                    target_verts=CREATURE_VERTS, res=CREATURE_RES)
        c = cs["rig"]
        rigs.append(sk.Rig(names=list(c.names), pos=c.joints.astype(float), parents=c.parents,
                           skins=c.skins))
        entries.append(build_mesh(c.verts, cs["tpl_edges"], cs["geo_edges"], TRACK_PAD,
                                  CREATURE_DEGREE, CREATURE_DEGREE))
        vtx0.append(pad_to(c.verts, TRACK_PAD))
        pts.append(cs["pts_traj"])
        jm = max(jm, len(c.joints))
    batched = dict(rigs=rigs, entries=entries, vtx0=np.stack(vtx0), pts=np.stack(pts),
                   max_joints=min((jm + 7) // 8 * 8, 48))
    print(f"tracking inputs: capsule V={len(cap.verts)} P={TRACK_P}; creatures V="
          f"{[len(v) for v in (e['vert_mask'].nonzero()[0] for e in entries)]} J="
          f"{[r.num_joints for r in rigs]} (max_joints {batched['max_joints']}) P={CREATURE_P}")
    return single, batched


def check_tracks(name: str, traj, vis, quats) -> None:
    norm = np.abs(np.linalg.norm(quats, axis=-1) - 1.0).max()
    if not (np.isfinite(traj).all() and np.isfinite(vis).all() and norm <= 1e-4):
        raise AssertionError(f"{name}: trajectories finite {np.isfinite(traj).all()}, "
                             f"vismasks finite {np.isfinite(vis).all()}, quaternion norms off "
                             f"1 by {norm}")


def track(name: str, run, args, frames: int, per_frame: dict,
          sequences: int = 1) -> tuple[dict, dict]:
    """One warm-up run (its kernel calls recorded and checked against the
    plain versions), then one timed run of `frames` steps over `sequences`
    sequences at once, with the kernel counts zeroed before it and read
    after it, which must be `per_frame` times the steps.  Returns
    (launches, per-part seconds summed over the steps)."""
    calls: dict = {}
    t0 = time.perf_counter()
    with recording_kernel_calls(calls):
        check_tracks(name, *run(*args))
    print(f"{name} warm-up: {time.perf_counter() - t0:.3f} s")
    check_recorded(name, calls)
    torch.cuda.reset_peak_memory_stats()
    timings: dict = {}
    zero_counts()
    t0 = time.perf_counter()
    out = run(*args, timings=timings)
    wall = time.perf_counter() - t0
    launches = read_counts()
    check_tracks(name, *out)
    expected = {k: v * frames for k, v in per_frame.items()}
    flow_ms = timings["flow"] * 1e3 / frames
    ik_ms = sum(timings[k] for k in IK_HALF) * 1e3 / frames
    print(f"{name}: {frames * sequences} tracked frames ({sequences} sequences x {frames}) in "
          f"{wall * 1e3:.2f} ms: {frames * sequences / wall:.3f} tracked frames/s; per step "
          f"{wall * 1e3 / frames:.2f} ms, flow {flow_ms:.2f} ms, IK "
          f"{ik_ms:.2f} ms (" + ", ".join(f"{k} {timings[k] * 1e3 / frames:.2f}" for k in IK_HALF)
          + f"); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"{name} kernel launches: {launches} ({ {k: v / frames for k, v in launches.items()} } "
          f"per step), expected {expected}")
    if not same_counts(launches, expected):
        raise AssertionError(f"{name}: kernel launches {launches} != expected {expected}")
    return launches, timings


def profile_tracker(name: str, frame_fn, flow_fn, timings: dict, frames: int) -> None:
    """One step under torch.profiler, and its flow alone: device ops, busy ms
    and idle share of the flow and of the IK half (the step less its flow;
    the idle share against the timed run's ms per step of each half)."""
    from torch.profiler import ProfilerActivity, profile

    stats = {}
    for part, fn in (("flow", flow_fn), ("frame", frame_fn)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = device_events(prof)
        stats[part] = (len(dev), sum(e.time_range.elapsed_us() for e in dev) / 1e3)
    walls = {"flow": timings["flow"] * 1e3 / frames,
             "IK": sum(timings[k] for k in IK_HALF) * 1e3 / frames}
    halves = {"flow": stats["flow"],
              "IK": tuple(f - g for f, g in zip(stats["frame"], stats["flow"]))}
    for half, (ops, busy) in halves.items():
        idle = f"{1 - busy / walls[half]:.3f}" if ops else "not measured (no device events)"
        print(f"profile {name} {half} per step: {ops} device ops, busy {busy:.2f} ms of "
              f"{walls[half]:.2f} ms, idle share {idle}")


def tracking(pred: RigPredictor, profile_phase: bool) -> dict:
    """The single tracker (`make_scanned_tracker`, full IK) on the capsule and
    the batched tracker on the creatures.  Per frame each runs one DeformNet
    forward: K1 once per edge layer, K2 three times, K3 six times (the
    point encoder).  Returns their timed runs' kernel counts, summed."""
    single, batched = tracking_inputs()
    frames = TRACK_FRAMES - 1
    per_frame = {"K1": sum(isinstance(m, EdgeMLP) for m in pred.deform.modules()), "K2": 3,
                 "K3": 6, "K4": 0, "K5": 0, "K6": 0}
    tracker = Tracker(pred.deform, single["rig"], single["entry"])
    cfg = tracker.cfg
    print(f"tracking: IK {cfg.ik_iters_stage1} + {cfg.ik_iters_stage2} iterations per frame")
    run = make_scanned_tracker(tracker)
    one, t_one = track("track single", run, (single["vtx0"], single["pts"]), frames, per_frame)
    bt = BatchedTracker(pred.deform, batched["rigs"], batched["entries"],
                        max_joints=batched["max_joints"])
    many, t_many = track(f"track batched NB={CREATURES}", bt.make_scanned(),
                         (batched["vtx0"], batched["pts"]), frames, per_frame, CREATURES)
    if profile_phase:
        dev = tracker.device
        v = torch.as_tensor(single["vtx0"], dtype=torch.float32, device=dev)
        p = torch.as_tensor(single["pts"][:, 1], device=dev)
        profile_tracker("track single", lambda: tracker._frame(v, p, StageTimer(None, dev)),
                        lambda: tracker._flow(v, p), t_one, frames)
        vb = torch.as_tensor(batched["vtx0"], dtype=torch.float32, device=dev)
        pb = torch.as_tensor(batched["pts"][:, :, 1], device=dev)
        profile_tracker(f"track batched NB={CREATURES}", lambda: bt._frame(vb, pb, StageTimer(None, dev)),
                        lambda: bt._flow(vb, pb), t_many, frames)
    return {k: one[k] + many[k] for k in one}


# kernel: (route, source, the TPU kernel it replaces).  The edge kernels K1,
# K5 and K6's recompute run the wgmma step code of csrc/edge_wgmma.cuh.
# ---------------------------------------------------------------------------
# phase 19: data- and tensor-parallel training
# ---------------------------------------------------------------------------

# Each rank of a sharded step runs every layer on its rows, so its kernel
# counts per step are the one-device step's (a tensor-parallel Dense is no
# kernel's).
PAR_STEPS = 5             # timed steps after the recorded one, sharded and on one device
# Held against the one-device step on the global batch at the CPU tests'
# tolerances (tests/test_torch_parallel.py): the losses within LOSS_RTOL;
# at data = 2 each gradient and the whole vector within DP_L2 relative L2
# (only the order of the weight gradients' sums over the rows and of the
# all-reduce changes); where a split layer's input gradient (a sum over the
# model group) reaches the edge layers, at model = 2 and 2 x 2, within K6's
# relative L2 bound K6_L2_TOL (bf16 rounding in K6 moves a few elements);
# each metric at the loss bound (the gradient norm at the whole vector's).
# On the card a rank's rows compute as in the whole
# batch: the split comparison (`parallel.steps.split_sources`) found that
# the first call to part was Dense's fp32 product on cuBLAS
# (nn/mlp.py, cuBLAS picks its kernel and split-K by the row count, and at
# model = 2 by the column count), then the jointnet loss's masked mean over
# a sample's points (losses/basic.py `_masked_mean`, whose reduction splits
# its rows otherwise with fewer of them); both now go through the
# row-invariant product KG (kernels/gemm.py).  The "batch"-mode step sums its
# moments over the rows, so no split leaves it bit-equal: it keeps the
# train tests' bounds PAR_BATCH_* (losses 2e-2, each gradient 0.8 relative
# L2, the whole vector 0.3, the running statistics 2e-2), its errors printed.
# A hold that fails runs the split comparison on its case and prints the
# first call that differs.  NCCL at world size 1 is the one-device step bit
# for bit.
LOSS_RTOL, DP_L2 = 1e-5, 1e-4
# A gradient zero by the loss's form (RootNet's back_layers.out.bias and
# mlp.ln_1.bias: the softmax cross-entropy's gradient sums to 0 over the
# joints) is rounding noise of a sum over the rows, whose order the split
# changes: held as zero (below ZERO_GRAD of the largest gradient on both
# sides) and, relative to that floor, within the 0.8 it was held to before.
PAR_ZERO_L2 = 0.8
PAR_BATCH_LOSS, PAR_BATCH_GRAD, PAR_BATCH_TOTAL, PAR_STATS_L2 = 2e-2, 0.8, 0.3, 2e-2
PAR_MESHES = (("data=2", 2, 1), ("model=2", 1, 2), ("data=2 x model=2", 2, 2))
PAR_EVERY_MESH = ("deform", "corr batch mode")


def parallel_cases(pose, rig, skel) -> dict:
    """Phase 19's cases: the seven stages on phases 6, 10 and 12's batches
    (CorrPoseStage with its visibility branch, as phase 6) and
    CorrPoseStage in "batch" norm mode, each with its expected counts per
    step (KG at least once: every fp32 Dense runs it); draws from a
    generator seeded 1.  The weights are
    `weights.randomize_`'s, heads included: the fresh heads are zero, so a
    first step's gradients would be zero behind them, and the motion
    stages' embeddings would sit at l2_normalize's zero vector, whose
    gradient is scaled by 1e6, where a sum over the batch in another order
    moves the motion head's gradient by up to 2x."""
    pb, rb, sb = (functools.partial(steps.stored_batch, steps.batch_bytes(b))
                  for b in (pose, rig, skel))
    corr = functools.partial(steps.corr_stage, True)
    C = functools.partial(steps.StepCase, randomize=7)
    return {c.name: (c, dict(e, KG=1)) for c, e in (
        (C("corr", corr, pb), EXPECTED_TRAIN),
        (C("deform", DeformPoseStage, pb), EXPECTED_DEFORM),
        (C("rig jointnet", functools.partial(RigStage, arch="jointnet"), rb), EXPECTED_MOTION),
        (C("rig masknet", functools.partial(RigStage, arch="masknet"), rb), EXPECTED_MOTION),
        (C("skin", SkinStage, rb), EXPECTED_MOTION),
        (C("bone", BoneStage, sb), EXPECTED_SKEL),
        (C("root", RootStage, sb), EXPECTED_SKEL),
        (C("corr batch mode", corr, pb, norm="batch"), EXPECTED_BATCH_CORR))}


@contextlib.contextmanager
def counted_first_step(counts: dict, calls: dict, kcalls: dict):
    """Around a rank's first step: the kernel counts zeroed before it and
    read after it into `counts`, its edge-layer calls recorded into
    `calls` and its K1/K2/K3/KS calls into `kcalls`."""
    zero_stage_counts()
    with recording_training_calls(calls), recording_kernel_calls(kcalls):
        yield
    counts.update(read_stage_counts())


def parallel_rank(rank: int, device, data: int, model: int, cases, repeat: bool) -> list:
    """One rank of phase 19 (`parallel.sharding.spawn`): an all-reduce over
    the world, then each case's sharded step (`parallel.steps.run_case`,
    1 + PAR_STEPS steps).  Rank 0 counts and records its first step and
    holds the recorded kernel calls to their plain versions.  With
    `repeat`, the first case again: a sharded init and REPRO_STEPS steps,
    twice, and the first tensor in which the runs part (None: equal bit
    for bit)."""
    mesh = make_device_mesh(data, model)
    one = torch.ones(1, device=device)
    dist.all_reduce(one)
    if int(one.item()) != data * model:
        raise AssertionError(f"rank {rank}: all_reduce of ones over the world gave {one.item()}")
    out = []
    for case, expected in cases:
        counts, calls, kcalls = {}, {}, {}
        first = (lambda _: counted_first_step(counts, calls, kcalls)) if rank == 0 else None
        rec = steps.run_case(case, device, mesh, 1 + PAR_STEPS, grads=rank == 0, on_first=first)
        if rank == 0:
            name = f"parallel {case.name} ({data} x {model}) rank 0"
            print(f"{name} kernel launches in its first step: {counts}, expected {expected}")
            check_counts(name, counts, expected)
            if calls:                  # "batch" norm mode: no edge kernel
                check_recorded_training(name, calls)
            if kcalls:
                check_recorded(name, kcalls)
            rec["counts"] = counts
        out.append(rec)
        del calls, kcalls
    if repeat:
        case = cases[0][0]
        runs = []
        for _ in range(2):
            stage, state = steps.build(case, device)
            state = shard_state(state, mesh, tensor_parallel=model > 1, reinit_opt=True)
            runs.append(run_steps(stage, shard_batch(case.batch(device), mesh), REPRO_STEPS,
                                  make_state=lambda s=state: s, mesh=mesh))
        out.append({"first_difference": first_difference(*runs), "tensors": len(runs[0])})
    return out


def collective_of(name: str, model: int) -> str:
    """The collective behind the first tensor two sharded runs part in (a
    `run_steps` record's name)."""
    if name.startswith("buffer"):
        return "MaskedBatchNorm's all-reduce of the moments over the data group"
    if " grad " in name or name.startswith("param"):
        return ("the data group's all-reduce of the gradients"
                + (" or the model group's all-reduce of a split layer's input gradient"
                   if model > 1 else ""))
    return "the data group's all-reduce of the losses"


def rank_devices(world: int) -> tuple[str, list]:
    """Phase 19's backend and cards for `world` ranks: NCCL with one rank
    per card where there are as many cards, else gloo with the ranks on the
    cards in turn (all on cuda:0 with one card)."""
    cards = torch.cuda.device_count()
    if cards >= world:
        return "nccl", [f"cuda:{i}" for i in range(world)]
    return "gloo", [f"cuda:{i}" for i in range(cards)]


def par_tolerances(case, data: int, model: int) -> tuple:
    """(each loss, each gradient, the whole vector, the running statistics)
    bounds of a phase-19 case on a data x model mesh."""
    if case.norm == "batch":
        return PAR_BATCH_LOSS, PAR_BATCH_GRAD, PAR_BATCH_TOTAL, PAR_STATS_L2
    if data * model == 1:
        return 0.0, 0.0, 0.0, 0.0
    grad = DP_L2 if model == 1 else K6_L2_TOL
    return LOSS_RTOL, grad, grad, DP_L2


def hold_parallel(label: str, name: str, got: dict, ref: dict, others: list, tol: tuple) -> None:
    """A sharded step's record against the one-device step's within `tol`
    (`par_tolerances`): each metric at the loss bound (the gradient norm at
    the whole vector's), each gradient, the whole vector, the running
    statistics; a gradient zero by the loss's form (below ZERO_GRAD of the
    largest on the one device) below that floor on the mesh too and within
    PAR_ZERO_L2 of it; the other ranks' losses must be rank 0's.  Prints
    the errors and the step medians."""
    loss_tol, grad_tol, total_tol, stats_tol = tol
    cmp = steps.compare(got, ref)
    norms = {n: float(torch.linalg.vector_norm(g.double())) for n, g in ref["grads"].items()}
    floor = steps.ZERO_GRAD * max(norms.values())
    zero = sorted(n for n, v in norms.items() if v < floor)
    worst = max((n for n in cmp["per"] if n not in zero), key=cmp["per"].get)
    zero_ok = all(cmp["per"][n] <= PAR_ZERO_L2
                  and float(torch.linalg.vector_norm(got["grads"][n].double())) < floor
                  for n in zero)
    stats = max((steps.rel_l2(got["buffers"][n], b) for n, b in ref["buffers"].items()),
                default=0.0)
    metrics = {k: abs(got["metrics"][k] - v) / max(abs(v), 1e-30)
               for k, v in ref["metrics"].items()}
    bad_metrics = {k: e for k, e in metrics.items()
                   if e > (total_tol if k == "grad_norm" else loss_tol)
                   and abs(got["metrics"][k] - ref["metrics"][k]) > 1e-12}
    med, ref_med = float(np.median(got["ms"])), float(np.median(ref["ms"]))
    print(f"parallel {label} {name}: loss rel err {cmp['loss']:.3g} (worst metric "
          f"{max(metrics.values()):.3g}), gradients rel L2 whole {cmp['total']:.3g}, worst "
          f"{cmp['per'][worst]:.3g} ({worst}), zero by the loss's form "
          f"{ {n: round(cmp['per'][n], 6) for n in zero} }, running statistics {stats:.3g}; bounds "
          f"{tol}; step median {med:.2f} ms (one device {ref_med:.2f} ms, {PAR_STEPS} steps "
          f"each); peak memory per rank "
          f"{[round(g, 2) for g in [got['peak_gib']] + [o['peak_gib'] for o in others]]} GiB "
          f"(one device {ref['peak_gib']:.2f})")
    bad = [o["metrics"] for o in others if o["metrics"] != got["metrics"]]
    if bad:
        raise AssertionError(f"parallel {label} {name}: the ranks' losses differ: "
                             f"{got['metrics']} vs {bad}")
    if bad_metrics or not (cmp["per"][worst] <= grad_tol and cmp["total"] <= total_tol
                           and stats <= stats_tol and zero_ok):
        raise AssertionError(f"parallel {label} {name}: the sharded step is not the one-device "
                             f"step within {tol}: metrics {bad_metrics}, {cmp['per'][worst]} "
                             f"({worst}), {cmp['total']}, {stats}, zero by form "
                             f"{ {n: cmp['per'][n] for n in zero} }")
    MEDIANS[f"parallel {label} {name}"] = med


def held(label: str, name: str, case, dev, data: int, model: int, *args) -> None:
    """`hold_parallel`; where it fails, the split comparison of the case on
    the same mesh (`parallel.steps.split_sources`) prints the first call
    whose rows part from the one-device step's, then the failure is
    raised."""
    try:
        hold_parallel(label, name, *args, par_tolerances(case, data, model))
    except AssertionError:
        backend, devices = rank_devices(data * model)
        diff = steps.split_sources([case], dev, data, model, backend, devices)[0]
        print(f"parallel {label} {name}: split comparison: {steps.describe(diff)}")
        raise


def parallel_phase(dev, pose, rig, skel) -> list[dict]:
    """Phase 19: each case's one-device step on the global batch, then its
    sharded steps on each mesh of PAR_MESHES (every case at data = 2,
    PAR_EVERY_MESH on all three), each held to the one-device step
    (`hold_parallel`) with rank 0's counts and recorded kernel calls
    checked; on the 2 x 2 mesh the deform step twice, bit for bit; the
    NCCL backend once at world size 1; `dryrun_multichip(4)`.  Returns rank
    0's counts of each counted step."""
    cases = parallel_cases(pose, rig, skel)
    card = gpu_name_power()
    torch.cuda.empty_cache()
    ref = {}
    for name, (case, _) in cases.items():
        ref[name] = steps.run_case(case, dev, None, 1 + PAR_STEPS)
        print(f"parallel one device {name}: step {median_line(ref[name]['ms'])}, total_loss "
              f"{ref[name]['metrics']['total_loss']:.6f}")
    counted = []
    for label, data, model in PAR_MESHES:
        world = data * model
        names = list(cases) if (data, model) == (2, 1) else list(PAR_EVERY_MESH)
        backend, devices = rank_devices(world)
        repeat = (data, model) == (2, 2)
        print(f"parallel {label}: backend {backend}, {world} ranks on {len(devices)} card(s) "
              f"({', '.join(devices)}); {card}")
        t0 = time.perf_counter()
        ranks = spawn(parallel_rank, world, backend, devices,
                      args=(data, model, [cases[n] for n in names], repeat))
        print(f"parallel {label}: {time.perf_counter() - t0:.1f} s for {world} ranks "
              f"(start-up, data, {len(names)} x {1 + PAR_STEPS} steps, rank 0's checks)")
        for i, name in enumerate(names):
            held(label, name, cases[name][0], dev, data, model, ranks[0][i], ref[name],
                 [r[i] for r in ranks[1:]])
            counted.append(ranks[0][i]["counts"])
        if repeat:
            firsts = [r[-1]["first_difference"] for r in ranks]
            print(f"parallel {label} repeat deform: a sharded init and {REPRO_STEPS} steps, "
                  f"twice, {ranks[0][-1]['tensors']} tensors per rank: "
                  + ("equal bit for bit on every rank" if not any(firsts) else
                     f"differ, first {firsts}"))
            if any(firsts):
                f = next(x for x in firsts if x)
                raise AssertionError(f"parallel {label}: two runs part at {f}: "
                                     f"{collective_of(f, model)}")
    print(f"parallel nccl: backend nccl, 1 rank on 1 card (cuda:0); {card}")
    ranks = spawn(parallel_rank, 1, "nccl", ["cuda:0"], args=(1, 1, [cases["deform"]], False))
    held("nccl 1 x 1", "deform", cases["deform"][0], dev, 1, 1, ranks[0][0], ref["deform"], [])
    counted.append(ranks[0][0]["counts"])
    backend, _ = rank_devices(4)
    dryrun_multichip(4, device="cuda", backend=backend)
    return counted


# ---------------------------------------------------------------------------
# phase 20: epoch-scanned training (train/scanned.py) against the loop
# ---------------------------------------------------------------------------

class RecordingLogger(MetricLogger):
    """A MetricLogger that keeps its records (and writes and prints
    nothing)."""

    def __init__(self):
        super().__init__(None)
        self.records = []

    def log(self, epoch, split, metrics, time_s=None, **extra_fields):
        self.records.append((epoch, split, time.time() if time_s is None else time_s,
                             dict(metrics)))


@dataclasses.dataclass
class ScanCase:
    """A phase-20 case: `make()` a fresh stage; `loop(rng, train)` the
    loop's epoch batches; `batcher` the same data on the card; epochs and
    chunk epochs; the launches of the train step (its graph's per replay)."""

    name: str
    make: object
    loop: object
    batcher: object
    epochs: int
    chunk: int
    expected: dict

    def ranges(self) -> list:
        boundary = getattr(self.make(), "vis_branch_start_epoch", None)
        return _chunk_ranges(0, self.epochs, self.chunk, boundary)


def scan_cases(rig_ds, skel) -> list:
    """Phase 20's cases on phases 6, 10, 12 and 17's data, batch 4 (one
    train and one val step per epoch): CorrPoseStage with the visibility
    branch from epoch 3, 7 epochs in chunks of 2 ([0, 2), [2, 3) cut short
    at the branch, [3, 5), [5, 7)); the same through K5 (the dataset's
    edge_tile=EDGE_TILE, the branch on from the start, 4 epochs); RigStage
    jointnet on `creature_rig_dataset(num_models=4, seed=0)`, 4 epochs;
    BoneStage on the skeleton batch (`const_scan_batcher`), 6 epochs in
    chunks of 3."""
    cases = []
    for label, tile, start, epochs, expected in (("corr", None, 3, 7, EXPECTED_TRAIN),
                                                 ("corr k5", EDGE_TILE, 0, 4, EXPECTED_TRAIN_K5)):
        ds = train_dataset(tile)

        def make(start=start):
            stage = CorrPoseStage()
            stage.vis_branch_start_epoch = start
            return stage

        cases.append(ScanCase(
            label, make,
            lambda rng, train, ds=ds: ds.epoch_batches(rng, TRAIN_B, "modelsresource", False,
                                                       train),
            pose_scan_batcher(ds, TRAIN_B, "modelsresource", False), epochs, 2, expected))
    cases.append(ScanCase("rig jointnet", lambda: RigStage(arch="jointnet"),
                          lambda rng, train: rig_ds.epoch_batches(rng, TRAIN_B, train),
                          rig_scan_batcher(rig_ds, TRAIN_B), 4, 2, EXPECTED_MOTION))

    def skel_batches(rng, train):
        yield skel

    cases.append(ScanCase("bone", BoneStage, skel_batches, const_scan_batcher(skel), 6, 3,
                          EXPECTED_SKEL))
    return cases


def run_scan_case(case: ScanCase, dev, ckpt_root: str) -> dict:
    """`run_epochs` and `run_epochs_scanned` from the same seeded weights,
    generator (seed 1) and schedule draws (default_rng(0)), each writing
    its checkpoints.  Returns {runner: (weights and buffers, best epoch, log
    records, launches, seconds, epoch seconds, the scanned run's stats)};
    the counts are zeroed just before each run and read just after it."""
    out = {}
    for runner in ("loop", "scan"):
        stage = case.make()
        state = full_width_state(f"scanned {case.name}", stage)
        gen = torch.Generator(device=dev).manual_seed(1)
        rng_np = np.random.default_rng(0)
        logger = RecordingLogger()
        ckdir = os.path.join(ckpt_root, f"{case.name} {runner}")
        stats: dict = {}
        torch.cuda.synchronize()
        zero_stage_counts()
        reset_replayed()
        t0 = time.time()
        if runner == "loop":
            state, best = run_epochs(stage, state, lambda e: case.loop(rng_np, True),
                                     lambda: case.loop(rng_np, False), None, case.epochs,
                                     checkpoint_dir=ckdir, logger=logger, generator=gen)
        else:
            state, best = run_epochs_scanned(stage, state, case.batcher, epochs=case.epochs,
                                             checkpoint_dir=ckdir, logger=logger,
                                             generator=gen, rng_np=rng_np,
                                             chunk_epochs=case.chunk, stats=stats)
        torch.cuda.synchronize()
        wall = time.time() - t0
        real, replayed = read_stage_counts(), replayed_launches()
        counts = {k: real[k] + replayed.get(k, 0) for k in real}
        if runner == "scan":
            stats["replayed"] = replayed
            epoch_s = [s / (b - a) for s, (a, b) in zip(stats["chunk_s"], case.ranges())]
        else:
            ends = [t for _, split, t, _ in logger.records if split == "val"]
            epoch_s = [float(x) for x in np.diff([t0] + ends)]
        files = sorted(os.listdir(ckdir))
        if files != ["checkpoint.pt", "checkpoint.pt.json", "model_best.pt",
                     "model_best.pt.json"]:
            raise AssertionError(f"scanned {case.name} {runner}: checkpoints {files}")
        weights = [t.detach().clone() for t in (*state.model.parameters(), *state.model.buffers())]
        out[runner] = (weights, best, logger.records, counts, wall, epoch_s, stats)
        del state, stage
    return out


def check_scan_case(case: ScanCase, runs: dict, card: str) -> None:
    """Phase 20's holds on one case: final weights and buffers, best epoch
    and logged metrics equal bit for bit; one host fetch per chunk; the
    scanned run's launches equal the loop's plus its warm-ups' (each capture
    first runs each program once eagerly, with the launches its graph
    records per replay); every kernel the loop launched also launched in a
    replay; the train graph launching `case.expected` per replay."""
    lw, lbest, lrec, lcounts, lwall, lepoch, _ = runs["loop"]
    sw, sbest, srec, scounts, swall, sepoch, st = runs["scan"]
    same_w = all(torch.equal(a, b) for a, b in zip(lw, sw))
    same_logs = [(e, s, m) for e, s, _, m in lrec] == [(e, s, m) for e, s, _, m in srec]
    worst = max((abs(a[k] - b[k]) / max(abs(a[k]), 1e-30)
                 for (*_, a), (*_, b) in zip(lrec, srec) for k in a), default=0.0)
    warm = {k: sum(per[prog].get(k, 0) for per in st["per_replay"] for prog in per)
            for k in lcounts}
    expected_scan = {k: lcounts[k] + warm[k] for k in lcounts}
    ranges, K = case.ranges(), case.batcher.steps_per_epoch
    steady = [i for i, c in enumerate(st["captured"]) if not c]
    steps = sum((ranges[i][1] - ranges[i][0]) * K for i in steady)
    scan_s = sum(st["chunk_s"][i] for i in steady)
    loop_s = sum(sum(lepoch[ranges[i][0]:ranges[i][1]]) for i in steady)
    train_graph = st["per_replay"][-1]["train"]
    print(f"scanned {case.name}: loop {lwall:.3f} s, epoch seconds "
          f"{[round(x, 4) for x in lepoch]}; scanned {swall:.3f} s ({st['captures']} captures, in "
          f"chunks {[i for i, c in enumerate(st['captured']) if c]} of {ranges}), chunk seconds "
          f"{[round(x, 4) for x in st['chunk_s']]}, epoch_wall_s {[round(x, 4) for x in sepoch]}; "
          f"steps/s over the chunks without a capture ({steps} steps and as many val steps): "
          f"loop {steps / loop_s:.3f}, scanned {steps / scan_s:.3f} (x{loop_s / scan_s:.2f}); "
          f"{card}")
    print(f"scanned {case.name}: bit for bit: weights and buffers {same_w}, best epoch {lbest} "
          f"/ {sbest}, logged metrics {same_logs} (largest relative difference {worst:.3g}); "
          f"host fetches per chunk {st['fetches'] / st['chunks']:.0f} ({st['fetches']} in "
          f"{st['chunks']} chunks, the replays under sync debug mode 'error'); launches per "
          f"replay: train {train_graph}, val {st['per_replay'][-1]['val']}; replayed "
          f"{st['replayed']}; loop {lcounts}; scanned, warm-ups and replays, {scounts}")
    if not (same_w and lbest == sbest and same_logs):
        raise AssertionError(f"scanned {case.name}: the scanned run differs from the loop")
    if st["fetches"] != st["chunks"]:
        raise AssertionError(f"scanned {case.name}: {st['fetches']} host fetches in "
                             f"{st['chunks']} chunks")
    if not same_counts(scounts, expected_scan):
        raise AssertionError(f"scanned {case.name}: launches {scounts} != the loop's plus the "
                             f"warm-ups' {expected_scan}")
    if not same_counts(train_graph, case.expected):
        raise AssertionError(f"scanned {case.name}: the train graph launches {train_graph}, "
                             f"expected {case.expected}")
    silent = [k for k, n in lcounts.items() if n and not st["replayed"].get(k)]
    if silent:
        raise AssertionError(f"scanned {case.name}: {silent} launched in the loop, never in a "
                             f"replay")


def step_profile(fn) -> tuple[float, int, float]:
    """(CUDA-event median ms, device ops, busy ms) of one call of fn."""
    from torch.profiler import ProfilerActivity, profile

    wall = median_ms(fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = device_events(prof)
    return wall, len(ev), sum(e.time_range.elapsed_us() for e in ev) / 1e3


def profile_scan_case(case: ScanCase, dev) -> None:
    """(--profile) One eager train step (the loop's first batch) against one
    replay of the captured step (`step_program`, the batcher's first row),
    each from fresh seeded weights: device ops, busy ms and idle share."""
    out = []
    for form in ("eager", "replayed"):
        stage = case.make()
        stage.on_epoch(case.epochs)
        state = full_width_state(f"scanned {case.name}", stage)
        gen = torch.Generator(device=dev).manual_seed(1)
        if form == "eager":
            batch = next(case.loop(np.random.default_rng(0), True))
            fn = lambda: stage.train_step(state, batch, gen)            # noqa: E731
        else:
            fn = step_program(stage, state, case.batcher, gen)
        wall, ops, busy = step_profile(fn)
        idle = f"{1 - busy / wall:.3f}" if ops else "not measured (no device events)"
        out.append(f"{form} {wall:.2f} ms, {ops} device ops, busy {busy:.2f} ms, idle {idle}")
        del state, stage
    print(f"profile scanned {case.name} train step: " + "; ".join(out))


def scanned_phase(dev, rig_ds, skel, profile_phase: bool) -> list[dict]:
    """Phase 20: each case of `scan_cases` through `run_epochs` and
    `run_epochs_scanned` (`run_scan_case`, `check_scan_case`); with
    --profile, a replayed step against an eager one.  Returns each run's
    launches (the scanned runs' replayed launches included)."""
    t0 = time.perf_counter()
    card = gpu_name_power()
    counted = []
    with tempfile.TemporaryDirectory() as root:
        for case in scan_cases(rig_ds, skel):
            runs = run_scan_case(case, dev, root)
            check_scan_case(case, runs, card)
            counted += [runs["loop"][3], runs["scan"][3]]
            if profile_phase:
                profile_scan_case(case, dev)
    print(f"scanned: phase 20 took {time.perf_counter() - t0:.1f} s")
    return counted


# ---------------------------------------------------------------------------
# phase 21: the convergence campaign (tools/torch_campaign.py) at its smoke size
# ---------------------------------------------------------------------------

# every kernel a campaign runs must launch (K1 and K6 in every stage, K2 in
# the corr and deform stages, K3 and KS in the losses' gathers); it passes
# no edge_tile, so K5 stays 0, and no path calls K4
CAMPAIGN_KERNELS = ("K1", "K2", "K3", "K6", "KS")
CAMPAIGN_STAGES = ("corr", "deform", "deform_seq", "joints", "mask", "skin", "bone", "root")


def load_tool(name: str):
    """tools/<name>.py of this checkout as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def counted_run(fn):
    """fn() with the kernel counts zeroed just before it and read just after
    it, the graph replays' launches added: (its result, the counts)."""
    torch.cuda.synchronize()
    zero_stage_counts()
    reset_replayed()
    out = fn()
    torch.cuda.synchronize()
    real, replayed = read_stage_counts(), replayed_launches()
    return out, {k: real[k] + replayed.get(k, 0) for k in real}


def check_campaign_counts(name: str, launches: dict, kernels) -> None:
    missing = [k for k in kernels if launches.get(k, 0) == 0]
    extra = [k for k in ("K4", "K5", "plain_edge") if launches.get(k, 0)]
    print(f"campaign {name} kernel launches: {launches}")
    if missing or extra:
        raise AssertionError(f"campaign {name}: kernels not launched {missing}, "
                             f"launched off the path {extra}")


def check_track_file(path: str) -> None:
    with np.load(path) as z:
        if not all(np.isfinite(z[k]).all() for k in ("pred_vtx_traj", "pred_vismask",
                                                      "pred_quats")):
            raise AssertionError(f"campaign: {path} holds a non-finite track")


def campaign_phase(dev, after=None) -> tuple[list[dict], list]:
    """Phase 21: `tools/torch_campaign.py --smoke` in a temporary directory
    (the eight stages 3 epochs each through the scanned runner, every step a
    CUDA-graph replay, then the held-out rig, skin and tracking evaluation),
    then `tools/torch_eval_campaign_tracking.py --frames 5 --timing-iters 1`
    on it, each run in this process with the counts zeroed before and read
    after it.  Every K1, K2, K3 and KS call of the campaign (the training
    steps' eager warm-ups, the flow dumps, the held-out `predict_rig_batch`,
    the skin evaluation, the tracking) and every training K1/K6 call, first of
    each shape, is recorded and held against its plain version.  The
    summary must be finite with IoU, precision and recall in [0, 1] and skin
    L1 >= 0, the tracks finite, each stage's files written.  Prints each
    stage's seconds, epochs and peak memory.  Then `after(directory)` while
    the directory is there.  Returns (both runs' launches, what `after`
    returned)."""
    t0 = time.perf_counter()
    campaign, track_eval = load_tool("torch_campaign"), load_tool("torch_eval_campaign_tracking")
    calls, tcalls = {}, {}
    with tempfile.TemporaryDirectory() as root:
        with recording_kernel_calls(calls), recording_training_calls(tcalls):
            summary, launches = counted_run(lambda: campaign.main(
                ["--dir", root, "--smoke", "--device", str(dev)]))
        check_campaign_counts("smoke", launches, CAMPAIGN_KERNELS)
        check_recorded("campaign", calls)
        check_recorded_training("campaign", tcalls)
        mean = summary["mean"]
        if not all(np.isfinite(v) for v in mean.values()):
            raise AssertionError(f"campaign: non-finite summary {mean}")
        for k in ("joint_IoU", "joint_precision", "joint_recall"):
            if not all(0.0 <= m[k] <= 1.0 for m in summary["per_model"]):
                raise AssertionError(f"campaign: {k} outside [0, 1]: {summary['per_model']}")
        if mean["skin_l1"] < 0:
            raise AssertionError(f"campaign: skin L1 {mean['skin_l1']} < 0")
        for stage in CAMPAIGN_STAGES:
            files = sorted(os.listdir(os.path.join(root, stage)))
            if not {"done.json", "metrics.jsonl", "model_best.pt", "checkpoint.pt"} <= set(files):
                raise AssertionError(f"campaign {stage}: files {files}")
        check_track_file(os.path.join(root, "results", "creature200_tracking.npz"))
        with open(os.path.join(root, "results", "campaign_timings.json")) as f:
            timings = json.load(f)
        print("campaign stages (seconds, epochs, peak GiB): " + "; ".join(
            f"{n} {t['seconds']:.2f} s, {t['epochs_run']}, {t['peak_gib']}"
            for n, t in timings["stages"].items()))
        h = timings["heldout"]
        print(f"campaign held-out: predict_rig_batch {h['predict_rig_batch_s']['default']:.2f} s, "
              f"tracking seq {h['tracking']['seq']['frames_per_s']:.3f} frames/s, "
              f"total {timings['total_s']:.1f} s; mean {json.dumps(mean)}; "
              f"{summary['device']['name']}, {summary['device']['power_limit']}")

        tracked, track_launches = counted_run(lambda: track_eval.main(
            ["--dir", root, "--frames", "5", "--timing-iters", "1", "--device", str(dev)]))
        check_campaign_counts("tracking eval", track_launches, ("K1", "K2", "K3"))
        if not all(np.isfinite([m["full_flow_error"], m["vis_flow_error"]]).all()
                   for m in tracked["per_model"]):
            raise AssertionError(f"campaign tracking eval: non-finite errors {tracked}")
        for m in tracked["per_model"]:
            check_track_file(os.path.join(root, "results", f"creature{m['seed']}_tracking.npz"))
        b = tracked["batched"]
        print(f"campaign tracking eval: {b['num_meshes']} x {b['frames_per_mesh']} frames, "
              f"{b['aggregate_frames_per_sec']:.3f} tracked frames/s (first call "
              f"{b['first_call_seconds']:.2f} s); mean {json.dumps(tracked['mean'])}")
        print(f"campaign: phase 21 took {time.perf_counter() - t0:.1f} s")
        later = after(root) if after is not None else []
    return [launches, track_launches], later


# ---------------------------------------------------------------------------
# phase 22: the joint-threshold sweep, its dump and the golden-path example
# ---------------------------------------------------------------------------

V3_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "campaign_v3")
SWEEP_TOL = 1e-4          # the sweep's metrics against the JAX sweep's v3 result
SWEEP_METRICS = ("joint_IoU", "joint_precision", "joint_recall", "chamfer_j2j")
EXAMPLE_STEPS = 12
EXPECTED_EXAMPLE_RIG = {"K2": EXPECTED_KNN_LAUNCHES, "K3": EXPECTED_GATHER_LAUNCHES}


def sweep_v3(dev) -> dict:
    """Phase 22 (a): the sweep on the committed v3 inputs against the v3
    result.  Returns its launches."""
    sweep = load_tool("torch_sweep_joint_params")
    with open(os.path.join(V3_DIR, "joint_sweep_result.json")) as f:
        ref = json.load(f)
    with tempfile.TemporaryDirectory() as d:
        os.symlink(os.path.join(V3_DIR, "joint_sweep_inputs.npz"),
                   os.path.join(d, "joint_sweep_inputs.npz"))
        out, launches = counted_run(lambda: sweep.main(["--dir", d, "--device", str(dev)]))
    got = out["result"]
    if got["best"] != dict(ref["best"], bandwidth_sample_rows=0):
        raise AssertionError(f"sweep: best {got['best']} != v3's {ref['best']}")
    worst = 0.0
    for g, r in zip(got["heldout"], ref["heldout"], strict=True):
        if (g["seed"], g["n_pred"], g["n_gt"]) != (r["seed"], r["n_pred"], r["n_gt"]):
            raise AssertionError(f"sweep: held-out {g} against v3's {r}")
        worst = max([worst] + [abs(g[k] - r[k]) for k in SWEEP_METRICS])
    if worst > SWEEP_TOL:
        raise AssertionError(f"sweep: held-out metrics off v3's by {worst} > {SWEEP_TOL}")
    print(f"sweep: v3 inputs on {got['device']['name']} ({got['device']['power_limit']}): best "
          f"{got['best']}, held-out joints {[g['n_pred'] for g in got['heldout']]} as v3's, "
          f"metrics within {worst:.3g} of v3's (tolerance {SWEEP_TOL}); mean IoU "
          f"{got['heldout_agg']['mean_iou']:.6f}; launches {launches}")
    return launches


def sweep_dump(dev, root: str) -> dict:
    """Phase 22 (b): the dump on phase 21's campaign directory `root`, at that
    run's creatures and sizes.  Returns its launches."""
    sweep, campaign = load_tool("torch_sweep_joint_params"), load_tool("torch_campaign")
    z = campaign.sizes(campaign.build_parser().parse_args(["--smoke"]))
    sweep.VAL_SEEDS, sweep.TEST_SEEDS = z["val"], z["test"]
    calls: dict = {}
    with recording_kernel_calls(calls):
        out, launches = counted_run(lambda: sweep.main(
            ["--dir", root, "--dump", "--device", str(dev), "--points", str(z["n_pts"]),
             "--target-verts", str(z["tv"])]))
    nets = [RigStage(arch=a).init_state(0, device=dev).model for a in ("jointnet", "masknet")]
    check_counts("sweep dump", launches, {"K1": 2 * edge_launches(*nets)})  # val and test
    check_recorded("sweep dump", calls)
    for k, v in out.items():
        if not (v.dtype == bool or np.isfinite(v).all()):
            raise AssertionError(f"sweep dump: {k} is not finite")
        if k.endswith("_inside") and not v.any():
            raise AssertionError(f"sweep dump: no shifted point of {k[:-7]} inside its volume")
    print(f"sweep dump: {', '.join(f'{k} {v.shape}' for k, v in out.items())}; inside "
          + ", ".join(f"{k[:-7]} {int(v.sum())}/{len(v)}" for k, v in out.items()
                      if k.endswith("_inside")) + f"; launches {launches}")
    return launches


@contextlib.contextmanager
def counting_predict_rig(seen: list):
    """Each `RigPredictor.predict_rig` call appends (predictor, rig, mesh
    entry, its kernel launches) to `seen`: the difference of the counts
    around the call, which go on counting for the run around it."""
    original = RigPredictor.predict_rig

    def call(self, mesh_entry, *args, **kw):
        torch.cuda.synchronize()
        before = read_stage_counts()
        rig = original(self, mesh_entry, *args, **kw)
        torch.cuda.synchronize()
        after = read_stage_counts()
        seen.append((self, rig, mesh_entry, {k: after[k] - before[k] for k in after}))
        return rig

    RigPredictor.predict_rig = call
    try:
        yield seen
    finally:
        RigPredictor.predict_rig = original


def golden_path(dev) -> dict:
    """Phase 22 (c): the example at EXAMPLE_STEPS steps.  Returns its
    launches."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                        "torch_capsule_end_to_end.py")
    spec = importlib.util.spec_from_file_location("torch_capsule_end_to_end", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    calls, tcalls, seen = {}, {}, []
    with tempfile.TemporaryDirectory() as d:
        with recording_kernel_calls(calls), recording_training_calls(tcalls), \
                counting_predict_rig(seen):
            out, launches = counted_run(lambda: example.main(
                ["--steps", str(EXAMPLE_STEPS), "--device", str(dev), "--out", d]))
        rig_file = os.path.getsize(out["rig_path"]) > 0
    check_recorded("example", calls)
    check_recorded_training("example", tcalls)
    if len(seen) != 1:
        raise AssertionError(f"example: {len(seen)} predict_rig calls")
    pred, rig, entry, rig_launches = seen[0]
    check_rig("example predict_rig", rig, int(np.asarray(entry["vert_mask"]).sum()), rig_launches,
              dict(EXPECTED_EXAMPLE_RIG, K1=expected_edge_launches(pred)))
    values = list(out["joints"].values()) + list(out["tracking"].values())
    if not (rig_file and np.isfinite(values).all()):
        raise AssertionError(f"example: rig file written {rig_file}, metrics {out}")
    print(f"example: {out['num_joints']} joints (GT {out['num_gt_joints']}), "
          f"{json.dumps(out['joints'])}, tracking {json.dumps(out['tracking'])}, "
          f"{out['frames_per_s']:.3f} tracked frames/s; predict_rig launches {rig_launches}; "
          f"launches {launches}; sections (s): "
          + ", ".join(f"{k} {v['total_s']:.2f}" for k, v in out["timings"].items()))
    return launches


def sweep_phase(dev, root: str) -> list[dict]:
    """Phase 22: (a), (b) on phase 21's directory `root`, then (c), each
    timed.  Returns their launches."""
    t_all, runs = time.perf_counter(), []
    for name, fn in (("v3 sweep", lambda: sweep_v3(dev)), ("dump", lambda: sweep_dump(dev, root)),
                     ("example", lambda: golden_path(dev))):
        t0 = time.perf_counter()
        runs.append(fn())
        print(f"sweep phase: {name} {time.perf_counter() - t0:.1f} s")
    print(f"sweep: phase 22 took {time.perf_counter() - t_all:.1f} s")
    return runs


SOURCES = {
    "K1": ("cuda", "morig_tpu_torch/csrc/edge_mlp.cu", "morig_tpu/kernels/edge_fused.py:102"),
    "K2": ("cuda", "morig_tpu_torch/csrc/knn_topk.cu", "morig_tpu/kernels/knn_fused.py:109"),
    "K3": ("cuda", "morig_tpu_torch/csrc/gather_rows.cu",
           "morig_tpu/kernels/gather_fused.py:88"),
    "K4": ("cuda", "morig_tpu_torch/csrc/knn_topk.cu", "morig_tpu/kernels/knn_fused.py:109"),
    "K5": ("cuda", "morig_tpu_torch/csrc/edge_mlp.cu", "morig_tpu/kernels/edge_fused.py:235"),
    "K6": ("cuda", "morig_tpu_torch/csrc/edge_mlp_bwd.cu",
           "morig_tpu/kernels/edge_fused.py:429"),
    # the port's own: the TPU kernels sum in their grid's order, XLA's
    # scatter-add is sequential on a TPU
    "KS": ("cuda", "morig_tpu_torch/csrc/row_scatter.cu", "none"),
    # the port's own: XLA's products on a TPU do not depend on the batch
    "KG": ("cuda", "morig_tpu_torch/csrc/gemm_f32.cu", "none"),
}


def main(profile_phase: bool = False):
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU; torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = gpu_name_power()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"({card}); torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = kb.build(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    kb.library()

    entries, frames = capsule_batch(B_MESH, T, P, V_PAD, DEGREE)
    mesh_bt = stack_meshes([e for e in entries for _ in range(T)])
    batch, _ = train_batch()
    results = {"K1": check_k1(dev, mesh_bt), "K2": check_k2(dev), "K3": check_k3(dev), "K4": check_k4(dev),
               "K5": check_k5(dev, mesh_bt, stack_meshes(entries)),
               "K6": check_k6(dev, batch.mesh), "KS": check_scatter(dev, batch.mesh),
               "KG": check_kg(dev)}
    check_k1_training(dev, batch.mesh)
    st = PROFILER_STATS
    print(f"profiler: {st['timings']} device timings, {st['retried']} taken again, "
          f"{st['fell_back']} from events behind a spin; least device-op start - launch "
          f"{st['least_skew_us']:.1f} us")

    pred = RigPredictor.random(0)                   # on the card
    edge = expected_edge_launches(pred)
    path1 = serve("path 1", pred, entries, frames,
                  {"K1": edge, "K2": EXPECTED_KNN_LAUNCHES,
                   "K3": EXPECTED_GATHER_LAUNCHES, "K4": 0, "K5": 0, "K6": 0})
    phase_a = phase_a_inputs(entries)
    pred2 = phase_a_predictor(0)
    cache: dict = {}
    path2 = serve("path 2", pred2, entries, frames,
                  {"K1": 0, "K2": EXPECTED_KNN_LAUNCHES,
                   "K3": EXPECTED_GATHER_LAUNCHES, "K4": 0, "K5": edge, "K6": 0},
                  device_cache=cache, **phase_a)
    if profile_phase:
        profile_programs("path 1", pred, entries, frames)
        profile_programs("path 2", pred2, entries, frames, device_cache=cache, **phase_a)
        profile_geometry(dev, entries, pred.cfg.joints)
    del pred2, cache
    trained, corr_state = train(batch, dev, profile_phase)
    motion = [train_deform(batch, corr_state, dev, profile_phase)]
    del corr_state
    rig_ds = creature_rig_dataset(num_models=TRAIN_B, seed=0)
    rig = rig_batch(rig_ds)
    motion += [train_motion("rig jointnet", RigStage(arch="jointnet"), rig, dev, profile_phase),
               train_motion("rig masknet", RigStage(arch="masknet"), rig, dev, profile_phase),
               train_motion("skin", SkinStage(), rig, dev, profile_phase)]
    skel = skel_batch()
    motion += [train_skel("bone", BoneStage(), skel, dev, profile_phase),
               train_skel("root", RootStage(), skel, dev, profile_phase)]
    demo_counts, demo_pred, demo_joint_counts = demo(dev)
    repro_phase(dev, batch, rig, skel, demo_pred, demo_joint_counts)
    del demo_pred
    batch_counts = batch_norm_phase(entries, frames, batch, dev, profile_phase)
    k5_counts = k5_training(dev, profile_phase)
    f32_counts = f32_inference(pred, entries, frames,
                               {"K1": edge, "K2": EXPECTED_KNN_LAUNCHES,
                                "K3": EXPECTED_GATHER_LAUNCHES})
    cli_counts = cli_phase(dev, edge)
    single = single_mesh(pred, entries[0], frames[0],
                         {"K1": edge, "K2": EXPECTED_KNN_LAUNCHES, "K3": EXPECTED_GATHER_LAUNCHES,
                          "K4": 0, "K5": 0, "K6": 0})
    tracked = tracking(pred, profile_phase)
    parallel = parallel_phase(dev, batch, rig, skel)
    scanned = scanned_phase(dev, rig_ds, skel, profile_phase)
    campaign, swept = campaign_phase(dev, after=lambda root: sweep_phase(dev, root))

    runs = [path1, path2, trained, *motion, demo_counts, batch_counts, k5_counts, f32_counts,
            cli_counts, single, tracked, *parallel, *scanned, *campaign, *swept]
    kernels = []
    for name, (route, src, rep) in SOURCES.items():
        n = sum(c.get(name, 0) for c in runs)
        kernels.append({"name": name, "route": route, "source": src, "replaces": rep,
                        "launches": n, **results[name].json()})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile each path's three device programs, FPS, the "
                             "clustering and one training step")
    main(parser.parse_args().profile)
