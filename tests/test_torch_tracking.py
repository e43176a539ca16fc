"""The port's tracking path against the JAX package: rotations, FK / LBS,
the IK solvers, `Tracker` / `make_scanned_tracker` / `BatchedTracker`, and
the creature generator.

Fixture: the capsule (n_lat=9, n_lon=8: V=74 padded to 128, degree-12
tables) animated over 3 frames with clouds of P=128 points (so the JAX kNN
runs its fused kernel, in interpret mode), and DeformNet with seeded random
parameters (heads included) as a JAX stage state, bridged to the port.

Tolerances, each beside the error measured on this CPU:
  * rotations, FK, LBS and their gradients: fp32 on both sides, FP32 =
    1e-5 (measured <= 4.8e-7, gradients <= 4.8e-7);
  * IK_TIGHT = 1e-5 for the IK at a cut iteration count (15-60, and the
    tracker's 40 + 40): fp32 autograd against jax.grad, summed in another
    order, then Adam; measured <= 9.5e-7 on rotations and positions;
  * IK_LOOSE = 1e-3 at the JAX test's 300 iterations of the bend case:
    where a gradient entry sits near 0, m / sqrt(v) can flip sign between
    two fp32 implementations and the angles then drift apart along
    directions the loss barely sees.  Here it did not happen (posed
    vertices 1.2e-7 apart, angles 3e-7); the bound leaves room for another
    CPU's rounding;
  * the tracker's vismask, behind DeformNet's edge layers: NETWORK
    (measured mean 1.1e-3, max 2.1e-3 relative).
"""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morig_tpu.core import batch as JB
from morig_tpu.core.config import TrackingConfig as JTrackingConfig
from morig_tpu.data import creature as jcr
from morig_tpu.geometry import fk as jfk
from morig_tpu.geometry import ik as jik
from morig_tpu.geometry import rotations as jrot
from morig_tpu.geometry import skeleton as jsk
from morig_tpu.pipelines import tracking as jtrk
from morig_tpu.train import stages as jst
from morig_tpu.train import trainer as jtr
from morig_tpu_torch import weights as W
from morig_tpu_torch.core.batch import build_mesh, pad_to
from morig_tpu_torch.core.config import TrackingConfig
from morig_tpu_torch.data import creature as tcr
from morig_tpu_torch.data import synthetic as tsyn
from morig_tpu_torch.geometry import fk as tfk
from morig_tpu_torch.geometry import ik as tik
from morig_tpu_torch.geometry import rotations as trot
from morig_tpu_torch.geometry import skeleton as tsk
from morig_tpu_torch.nn import deformnet as tdn
from morig_tpu_torch.pipelines import tracking as ttrk

import torch_port_fixtures as F
from torch_port_fixtures import NETWORK, assert_rel_close

V_PAD, P = 128, 128
FP32 = 1e-5
IK_TIGHT = 1e-5
IK_LOOSE = 1e-3


def t_(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# rotations, FK, LBS
# ---------------------------------------------------------------------------

def _angles(rng, n=40):
    a = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    a[:4, 1] = [np.pi / 2, -np.pi / 2, np.pi / 2 - 1e-4, 1.5]      # gimbal lock and near it
    a[4:8] = [[np.pi - 0.01, 0, 0], [0, np.pi - 0.01, 0], [0, 0, np.pi - 0.01],
              [0.3, 0.2, 0.1]]                                    # each quaternion branch
    return a


@pytest.mark.parametrize("fn", ["euler_to_matrix", "matrix_to_euler", "matrix_to_6d",
                                "sixd_to_matrix", "matrix_to_quaternion",
                                "quaternion_to_matrix"])
def test_rotations_match_jax(fn):
    """Each conversion on the same inputs, gimbal-locked and every
    quaternion branch among them: FP32."""
    rng = np.random.default_rng(0)
    R = np.asarray(jrot.euler_to_matrix(jnp.asarray(_angles(rng))))
    inputs = {"euler_to_matrix": _angles(rng), "matrix_to_euler": R, "matrix_to_6d": R,
              "sixd_to_matrix": rng.standard_normal((40, 6)).astype(np.float32),
              "matrix_to_quaternion": R,
              "quaternion_to_matrix": np.asarray(jrot.matrix_to_quaternion(jnp.asarray(R)))}
    x = inputs[fn]
    got, ref = getattr(trot, fn)(torch.as_tensor(x)), getattr(jrot, fn)(jnp.asarray(x))
    F.assert_close(got, ref, atol=FP32, what=fn)


def _tree(rng, parents):
    J = len(parents)
    R = np.asarray(jrot.euler_to_matrix(jnp.asarray(rng.uniform(-1, 1, (J, 3)), jnp.float32)))
    return R, rng.standard_normal((J, 3)).astype(np.float32), \
        rng.standard_normal(3).astype(np.float32)


PARENTS = np.array([-1, 0, 1, 1, 0, 4, 4, 4, 2, 8, 9])


def test_fk_and_its_gradients_match_jax():
    """fk on a branching 11-joint tree with a root translation: G, q and the
    gradients of a weighted sum of both with respect to the local
    rotations, offsets and root translation, FP32."""
    rng = np.random.default_rng(1)
    R, off, rt = _tree(rng, PARENTS)
    cG, cq = rng.standard_normal((len(PARENTS), 3, 3)), rng.standard_normal((len(PARENTS), 3))
    jt, tt = jfk.FKTopology(PARENTS), tfk.FKTopology(PARENTS)

    def jloss(R_, off_, rt_):
        G, q = jfk.fk(jt, R_, off_, rt_)
        return jnp.sum(G * cG) + jnp.sum(q * cq)

    ref = jfk.fk(jt, jnp.asarray(R), jnp.asarray(off), jnp.asarray(rt))
    ref_g = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(R), jnp.asarray(off), jnp.asarray(rt))
    args = [torch.tensor(a, requires_grad=True) for a in (R, off, rt)]
    G, q = tfk.fk(tt, *args)
    (G * t_(cG).float()).sum().add((q * t_(cq).float()).sum()).backward()
    F.assert_close(G, ref[0], atol=FP32, what="G")
    F.assert_close(q, ref[1], atol=FP32, what="q")
    for a, g, name in zip(args, ref_g, ("d local", "d offsets", "d root")):
        F.assert_close(a.grad, g, atol=FP32, what=name)


def _padded_rigs(rng, Jm=16):
    """Three trees of different shapes and depths padded to Jm joints, as
    arrays."""
    rigs = [PARENTS, np.array([-1, 0, 1]), np.array([2, 0, -1, 2, 3, 3])]
    out = [], [], [], [], []
    depth = 0
    for parents in rigs:
        p, lv, d = tfk.topology_arrays(parents, Jm)
        depth = max(depth, d)
        R, off, rt = _tree(rng, parents)
        Rp = np.tile(np.eye(3, dtype=np.float32), (Jm, 1, 1))
        Rp[:len(parents)] = R
        op = np.zeros((Jm, 3), np.float32)
        op[:len(parents)] = off
        for lst, x in zip(out, (p, lv, Rp, op, rt)):
            lst.append(x)
    return [np.stack(x) for x in out], depth


@pytest.mark.parametrize("fn", ["fk_masked", "fk_masked_doubling"])
def test_fk_masked_matches_jax(fn):
    """Array-topology FK over three rigs of different trees in one batch
    against the JAX function vmapped: FP32; the real joints equal `fk`'s."""
    rng = np.random.default_rng(2)
    (p, lv, R, off, rt), depth = _padded_rigs(rng)
    for a, b in zip(tfk.topology_arrays(PARENTS, 16), jfk.topology_arrays(PARENTS, 16)):
        np.testing.assert_array_equal(a, b)
    got = getattr(tfk, fn)(t_(p).long(), t_(lv).long(), t_(R), t_(off), depth, t_(rt))
    ref = jax.vmap(lambda *a: getattr(jfk, fn)(*a[:4], depth, a[4]))(p, lv, R, off, rt)
    for g, r, name in zip(got, ref, ("G", "q")):
        F.assert_close(g, r, atol=FP32, what=name)
    _, q1 = tfk.fk(tfk.FKTopology(PARENTS), t_(R[0, :11]), t_(off[0, :11]), t_(rt[0]))
    F.assert_close(got[1][0, :11], q1, atol=FP32)


def test_lbs_matches_jax():
    """blend_palette, lbs_blend, lbs_from_local, verts_to_local and lbs_rest
    on posed FK outputs: FP32."""
    rng = np.random.default_rng(3)
    R, off, rt = _tree(rng, PARENTS)
    topo = jfk.FKTopology(PARENTS)
    G, q = (np.asarray(x) for x in jfk.fk(topo, jnp.asarray(R), jnp.asarray(off),
                                           jnp.asarray(rt)))
    G0, q0 = (np.asarray(x) for x in jfk.fk(topo, jnp.asarray(np.tile(np.eye(3, dtype=np.float32),
                                                                       (11, 1, 1))),
                                             jnp.asarray(off)))
    verts = rng.standard_normal((60, 3)).astype(np.float32)
    skins = rng.random((60, 11)).astype(np.float32)
    skins /= skins.sum(1, keepdims=True)
    vl = np.asarray(jfk.verts_to_local(G0, q0, verts))
    cases = {"blend_palette": (G, q, G0, q0), "lbs_blend": (G, q, G0, q0, verts, skins),
             "verts_to_local": (G0, q0, verts), "lbs_from_local": (G, q, vl, skins),
             "lbs_rest": (verts, off, skins, G, q)}
    for name, args in cases.items():
        F.assert_close(getattr(tfk, name)(*map(t_, args)), getattr(jfk, name)(*args),
                       atol=FP32, what=name)


# ---------------------------------------------------------------------------
# IK
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bend():
    """tests/test_fk_ik.py's bend case: the n_lat=9 capsule bent at its
    middle and tip joints, every vertex a visible constraint."""
    cap = tsyn.make_capsule_rig(9, 8)
    offsets = cap.joints.copy()
    offsets[1:] = cap.joints[1:] - cap.joints[cap.parents[1:]]
    locals_ = np.stack([np.eye(3, dtype=np.float32), tsyn.rotz(0.5), tsyn.rotz(0.3)])
    targets = tsyn.lbs_numpy(cap.verts, cap.joints, cap.parents, cap.skins,
                             locals_).astype(np.float32)
    eye = np.repeat(np.eye(3, dtype=np.float32)[None], 3, 0)
    G0, q0 = (np.asarray(x) for x in jfk.fk(jfk.FKTopology(cap.parents), jnp.asarray(eye),
                                             jnp.asarray(offsets)))
    V = len(cap.verts)
    args = (eye, offsets, G0, q0, cap.verts, cap.skins, np.arange(V), targets, np.ones(V, np.float32))
    return dict(cap=cap, args=args, targets=targets)


def _solve_both(bend, iters, lr=5e-2):
    cap = bend["cap"]
    ref = jik.make_ik_solver(jfk.FKTopology(cap.parents), jik.IKConfig(iters=iters, lr=lr))(
        *map(jnp.asarray, bend["args"]))
    got = tik.make_ik_solver(tfk.FKTopology(cap.parents), tik.IKConfig(iters=iters, lr=lr))(
        *map(t_, bend["args"]))
    return got, ref


@pytest.mark.parametrize("iters", [15, 60])
def test_ik_solver_matches_jax(bend, iters):
    """make_ik_solver at a cut iteration count: local rotations, global
    rotations and joint positions within IK_TIGHT."""
    got, ref = _solve_both(bend, iters)
    for g, r, name in zip(got, ref, ("locals", "G", "q")):
        F.assert_close(g, r, atol=IK_TIGHT, what=name)


def test_ik_solver_at_the_jax_tests_iteration_count(bend):
    """The bend case at its 300 iterations: both solvers recover the bend
    (mean vertex error under a tenth of the start's), and their posed
    vertices agree within IK_LOOSE."""
    got, ref = _solve_both(bend, 300)
    cap, args = bend["cap"], bend["args"]
    posed = [np.asarray(mod.lbs_blend(G, q, *map(conv, args[2:6])))
             for mod, conv, (_, G, q) in ((tfk, t_, got), (jfk, jnp.asarray, ref))]
    init = np.linalg.norm(cap.verts - bend["targets"], axis=1).mean()
    for p in posed:
        assert np.linalg.norm(p - bend["targets"], axis=1).mean() < 0.1 * init
    F.assert_close(posed[0], posed[1], atol=IK_LOOSE, what="posed")


def test_ik_solver_masked_matches_jax():
    """make_ik_solver_masked on three rigs with different trees, padded
    joints and invalid constraints, batched, against the JAX solver vmapped
    over them, at 30 iterations: IK_TIGHT."""
    rng = np.random.default_rng(4)
    (p, lv, R, off, _), depth = _padded_rigs(rng, Jm=16)
    Bn, Jm, V, N = 3, 16, 40, 30
    eye = np.tile(np.eye(3, dtype=np.float32), (Bn, Jm, 1, 1))
    G0, q0 = (np.asarray(x) for x in jax.vmap(lambda *a: jfk.fk_masked_doubling(*a, depth))(
        p, lv, eye, off))
    skins = np.zeros((Bn, V, Jm), np.float32)
    for i, J in enumerate((11, 3, 6)):
        skins[i, :, :J] = rng.random((V, J))
    skins /= skins.sum(-1, keepdims=True)
    verts = rng.standard_normal((Bn, V, 3)).astype(np.float32)
    idx = rng.integers(0, V, (Bn, N))
    targets = (verts[np.arange(Bn)[:, None], idx] + 0.1).astype(np.float32)
    vis = rng.random((Bn, N)).astype(np.float32)
    valid = (rng.random((Bn, N)) < 0.8).astype(np.float32)
    args = (eye, off, p, lv, G0, q0, verts, skins, idx, targets, vis, valid)
    cfg = dict(iters=30, lr=5e-2, vismask_threshold=0.3)
    ref = jax.vmap(jik.make_ik_solver_masked(depth, jik.IKConfig(**cfg)))(*map(jnp.asarray, args))
    got = tik.make_ik_solver_masked(depth, tik.IKConfig(**cfg))(
        t_(eye), t_(off), t_(p).long(), t_(lv).long(), *map(t_, args[4:8]), t_(idx),
        *map(t_, args[9:]))
    for g, r, name in zip(got, ref, ("locals", "G", "q")):
        F.assert_close(g, r, atol=IK_TIGHT, what=name)


# ---------------------------------------------------------------------------
# trackers
# ---------------------------------------------------------------------------

def _rig(mod, c):
    return mod.Rig(names=list(c.names), pos=c.joints.astype(float), parents=c.parents,
                   skins=c.skins)


@pytest.fixture(scope="module")
def track():
    """A capsule sequence (bent by up to 0.4, whole-surface clouds), its rig,
    and DeformNet as a JAX stage state and as the port's module."""
    seq = tsyn.make_capsule_sequence(num_frames=3, num_points=P, n_lat=9, n_lon=8,
                                     partial=False, max_bend=0.4)
    cap = seq["rig"]
    entry = build_mesh(cap.verts, seq["tpl_edges"], seq["geo_edges"], V_PAD, 12, 12)
    stage = jst.DeformPoseStage()
    jm = JB.stack_meshes([entry])
    jp = JB.PointBatch(jnp.asarray(seq["pts_traj"][None, :, 0]), jnp.ones((1, P), bool))
    params = F.flax_params(stage.model, 60, jm, jp, False, None)
    state = jtr.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=flax.core.freeze({}), opt_state=None, tx=None,
                           apply_fn=stage.model.apply)
    deform = F.bridged(tdn.DeformNet, W.flax_to_state_dict(params))
    return dict(seq=seq, cap=cap, entry=entry, stage=stage, state=state, deform=deform,
                nv=len(cap.verts))


def _cfg(mod, iters1, iters2, **kw):
    return mod(ik_iters_stage1=iters1, ik_iters_stage2=iters2, **kw)


# Random embeddings are nearly orthogonal (each point's best similarity is at
# most 0.16 here), so the gate's default thresholds (0.5, 1e-2) keep no
# point; these keep about a third of them.
OPEN_GATE = dict(corr_sim_threshold=0.05, corr_l2_threshold=0.1)


def test_tracker_step_on_jax_flow_matches_jax(track):
    """Tracker.step with the port's `_flow` returning the JAX DeformNet's
    outputs for the vertices it is given, so the IK, the gate and the LBS
    are held apart from the bf16 flow: two frames at 40 + 40 IK
    iterations, the gate's thresholds at OPEN_GATE, vertices and quaternions within IK_TIGHT, the vismask within
    FP32 (the second frame's flow is taken at each side's own vertices)."""
    cap, seq = track["cap"], track["seq"]
    with F.jax_fused_kernels():
        ref = jtrk.Tracker(track["stage"], track["state"], _rig(jsk, cap), track["entry"],
                           cfg=_cfg(JTrackingConfig, 40, 40, **OPEN_GATE))
        got = ttrk.Tracker(track["deform"], _rig(tsk, cap), track["entry"],
                           cfg=_cfg(TrackingConfig, 40, 40, **OPEN_GATE))
        got._flow = lambda verts, pts: tuple(t_(x) for x in ref._flow(F.np_(verts), F.np_(pts)))
        g_state, r_state = ttrk.TrackState(cap.verts, None, None), jtrk.TrackState(cap.verts, None, None)
        for t in (1, 2):
            r_state = ref.step(r_state, seq["pts_traj"][:, t])
            g_state = got.step(g_state, seq["pts_traj"][:, t])
            F.assert_close(g_state.verts, r_state.verts, atol=IK_TIGHT, what=f"verts {t}")
            F.assert_close(g_state.quats, r_state.quats, atol=IK_TIGHT, what=f"quats {t}")
            F.assert_close(g_state.vismask, r_state.vismask, atol=FP32, what=f"vismask {t}")
    w = got._corr_filter(*got._flow(t_(g_state.verts), t_(seq["pts_traj"][:, 2]))[1:3],
                         t_(g_state.verts), t_(seq["pts_traj"][:, 2]),
                         t_(g_state.vismask))[1]
    assert 0 < float(w.sum()) < P                      # the gate keeps some points


def test_tracker_run_at_zero_iterations_matches_jax(track):
    """Tracker.run end to end with the port's own flow at 0 IK iterations
    (the pose is then the initial angles, whatever the flow): trajectory
    and quaternions within FP32, the vismask at NETWORK; and
    make_scanned_tracker returns Tracker.run's arrays exactly."""
    cap, seq = track["cap"], track["seq"]
    with F.jax_fused_kernels():
        ref = jtrk.Tracker(track["stage"], track["state"], _rig(jsk, cap), track["entry"],
                           cfg=_cfg(JTrackingConfig, 0, 0)).run(cap.verts, seq["pts_traj"])
    tracker = ttrk.Tracker(track["deform"], _rig(tsk, cap), track["entry"],
                           cfg=_cfg(TrackingConfig, 0, 0))
    got = tracker.run(cap.verts, seq["pts_traj"])
    nv = track["nv"]
    assert [g.shape for g in got] == [(nv, 2, 3), (nv, 2), (3, 2, 4)]
    F.assert_close(got[0], ref[0], atol=FP32, what="trajectory")
    assert_rel_close(got[1], ref[1], NETWORK, what="vismask")
    F.assert_close(got[2], ref[2], atol=FP32, what="quaternions")
    timings: dict = {}
    scanned = ttrk.make_scanned_tracker(tracker)(cap.verts, seq["pts_traj"], timings=timings)
    for g, s in zip(got, scanned):
        np.testing.assert_array_equal(g, s)
    assert set(timings) == {"flow", "ik1", "gate", "ik2"}


def _batch(track):
    """Two meshes: the capsule and a smaller copy of it (another rig) with
    its own cloud."""
    cap, seq = track["cap"], track["seq"]
    small = dataclasses.replace(cap, verts=cap.verts * 0.8, joints=cap.joints * 0.8)
    entries = [track["entry"], build_mesh(small.verts, seq["tpl_edges"], seq["geo_edges"],
                                          V_PAD, 12, 12)]
    vtx0 = np.stack([pad_to(c.verts, V_PAD) for c in (cap, small)])
    pts = np.stack([seq["pts_traj"], seq["pts_traj"] * 0.8])
    return (cap, small), entries, vtx0, pts


def test_batched_tracker_matches_port_tracker(track):
    """BatchedTracker (array topologies, both IK stages batched over rigs)
    reproduces the port's single Tracker per mesh at 15 + 15 iterations
    (the JAX package's own test of its BatchedTracker, at its tolerances:
    trajectories 2e-3, vismasks 1e-4, quaternions 2e-3; measured <= 1e-5)."""
    caps, entries, vtx0, pts = _batch(track)
    cfg = _cfg(TrackingConfig, 15, 15)
    run = ttrk.BatchedTracker(track["deform"], [_rig(tsk, c) for c in caps], entries, cfg,
                              max_joints=8).make_scanned()
    traj, vis, quats = run(vtx0, pts)
    assert traj.shape == (2, V_PAD, 2, 3) and quats.shape == (2, 8, 2, 4)
    nv = track["nv"]
    for i, c in enumerate(caps):
        single = ttrk.make_scanned_tracker(ttrk.Tracker(track["deform"], _rig(tsk, c), entries[i],
                                                        cfg))(c.verts, pts[i])
        np.testing.assert_allclose(traj[i, :nv], single[0], atol=2e-3)
        np.testing.assert_allclose(vis[i, :nv], single[1], atol=1e-4)
        np.testing.assert_allclose(quats[i, :3], single[2], atol=2e-3)
    np.testing.assert_array_equal(traj[:, nv:], 0.0)


def test_batched_tracker_matches_jax(track):
    """BatchedTracker against the JAX BatchedTracker's scanned program, each
    with its own flow, at 0 IK iterations: trajectories and quaternions
    within FP32 (padded rows and joints included), vismasks at NETWORK."""
    caps, entries, vtx0, pts = _batch(track)
    with F.jax_fused_kernels():
        ref = jtrk.BatchedTracker(track["stage"], track["state"], [_rig(jsk, c) for c in caps],
                                  entries, cfg=_cfg(JTrackingConfig, 0, 0),
                                  max_joints=8).make_scanned()(vtx0, pts)
    got = ttrk.BatchedTracker(track["deform"], [_rig(tsk, c) for c in caps], entries,
                              _cfg(TrackingConfig, 0, 0), max_joints=8).make_scanned()(vtx0, pts)
    F.assert_close(got[0], ref[0], atol=FP32, what="trajectories")
    vm = np.asarray([e["vert_mask"] for e in entries])
    assert_rel_close(got[1], ref[1], NETWORK, vm, "vismasks")
    F.assert_close(got[2], ref[2], atol=FP32, what="quaternions")


# ---------------------------------------------------------------------------
# the creature generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [100, 101])
def test_creature_sequence_matches_jax_package(seed):
    """make_creature_sequence at bench phase B2's settings (fewer frames and
    points), bit for bit: every array, the rig and its names."""
    kw = dict(seed=seed, num_frames=3, num_points=128, target_verts=900, res=40)
    got, ref = tcr.make_creature_sequence(**kw), jcr.make_creature_sequence(**kw)
    assert got.keys() == ref.keys()
    for k in ref:
        if k != "rig":
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for f in dataclasses.fields(ref["rig"]):
        a, b = getattr(got["rig"], f.name), getattr(ref["rig"], f.name)
        assert a == b if f.name == "names" else np.array_equal(a, b), f.name
    ds = tcr.creature_pose_dataset(num_models=1, seed=seed, num_frames=3, num_points=128,
                                   target_verts=900, res=40)
    np.testing.assert_array_equal(ds.models[0].vtx_traj, ref["vtx_traj"])
