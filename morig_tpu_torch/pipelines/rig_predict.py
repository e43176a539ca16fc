"""Rig prediction: rest meshes + point-cloud keyframes -> skinned rigs.

Counterpart of morig_tpu/pipelines/rig_predict.py.  Two paths, as there:

The single-mesh API (`predict_flow`, `predict_shift_attn`,
`predict_joints`, `predict_skel`, `predict_skin`, `predict_rig`) takes and
returns host arrays at every stage boundary: DeformNet on the mesh
repeated T times, JointNet + MaskNet, `extract_joints` (host filtering,
device mean-shift on the unpadded cloud, host NMS), `predict_skeleton`,
then numpy skin descriptors and scatter with device smoothing.

The batched DAG `predict_rig_batch`, with or without voxel grids and
surface geodesics, is three device programs with host work between them:

  1. flow_joints: DeformNet over the B*T keyframes (mesh embedding once per
     mesh), JointNet + MaskNet, bandwidth + mean-shift        (device)
  2. NMS + flip, joint cap by density                          (host)
  3. skelnets: RootNet + BoneNet over the padded joint pairs  (device)
  4. Prim MST (with voxels: outside-bone cost)                 (host)
  5. skin_full: bone distances (euclidean, or volumetric geodesics with
     voxels and surface geodesics), descriptors, SkinMotion,
     smoothing, pruning                                        (device)
  6. rig assembly                                              (host)

The device programs return fp32 on the device the networks live on.
"""
from __future__ import annotations

import itertools
import time
from typing import Optional, Sequence

import numpy as np
import torch

from morig_tpu_torch.core.batch import MeshBatch, PointBatch, stack_meshes
from morig_tpu_torch.core.config import DEFAULT_CONFIG, Config
from morig_tpu_torch.eval.torch_import import IMPORTERS
from morig_tpu_torch.geometry import skeleton as sk
from morig_tpu_torch.geometry.bones import (pack_skin_descriptors, point_to_segment_dist,
                                            scatter_skin_full)
from morig_tpu_torch.geometry.clustering import (extract_joints, nms_flip_host,
                                                 select_and_cluster)
from morig_tpu_torch.geometry.geodesic import vertex_bone_geodesic_device
from morig_tpu_torch.geometry.skinning import post_filter_skin, prune_and_normalize
from morig_tpu_torch.geometry.voxel import (Voxels, inside_check_np, segment_inside_fraction,
                                            vox_to_device)
from morig_tpu_torch.nn.bonenet import BoneNet, RootNet
from morig_tpu_torch.nn.deformnet import DeformNet
from morig_tpu_torch.nn.gcu import auto_select_edge_impl
from morig_tpu_torch.nn.rignet import JointNetMotion, MaskNetMotion, SkinMotion
from morig_tpu_torch.pipelines.skeleton import predict_skeleton
from morig_tpu_torch.weights import flax_to_state_dict, randomize_

# the six networks, in RigPredictor's argument order, and their keys
NETS = ("deform", "joint", "mask", "root", "bone", "skin")
NET_CLASSES = (DeformNet, JointNetMotion, MaskNetMotion, RootNet, BoneNet, SkinMotion)


def batch_fingerprint(Bn: int, T: int, mesh_entries: Sequence[dict]) -> tuple:
    """Content fingerprint of a mesh batch (shapes and cheap checksums, not
    object ids, which CPython reuses) that validates a device cache."""
    def _entry_fp(e):
        v = e["verts"]
        return (v.shape, float(v.sum()), float(np.abs(v).sum()),
                int(e["vert_mask"].sum()), int(e["tpl_nbr"].sum()),
                int(e["geo_nbr"].sum()))

    return (Bn, T, tuple(_entry_fp(e) for e in mesh_entries))


class StageTimer:
    """Adds the seconds since the previous mark to timings[name] at each
    `mark(name)`, synchronizing the card first; inert when `timings` is
    None."""

    def __init__(self, timings: Optional[dict], device: torch.device):
        self.timings, self.device = timings, device
        self.last = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + now - self.last
        self.last = now


def pair_table(max_joints: int) -> np.ndarray:
    """All (i, j) joint pairs with i < j, row-major: (P, 2) int64."""
    return np.array(list(itertools.combinations(range(max_joints), 2)), np.int64)


def bone_slots(num_bones: int, max_joints: int) -> int:
    """Padded bone axis: the batch's bone count rounded up to a power of two,
    at least 8, at most 2 * max_joints."""
    n = 8
    while n < num_bones:
        n *= 2
    return min(n, 2 * max_joints)


def joints_from_clusters(clusters: Sequence[np.ndarray], mesh_entries: Sequence[dict],
                         max_joints: int, density_threshold: float = 0.02,
                         attn_nms_threshold: float = 0.7) -> list:
    """Host NMS + flip over the fetched (moved, bw, counts, attn2, sel2); a mesh
    with no mode gets one joint at its centroid, one with more than
    max_joints keeps the densest."""
    joints_list = []
    for i, (j, dens) in enumerate(nms_flip_host(
            *clusters, density_threshold=density_threshold,
            attn_nms_threshold=attn_nms_threshold, return_density=True)):
        if len(j) == 0:
            vmask = np.asarray(mesh_entries[i]["vert_mask"])
            j = mesh_entries[i]["verts"][vmask].mean(0, keepdims=True)
        elif len(j) > max_joints:
            j = j[np.argsort(-np.asarray(dens), kind="stable")[:max_joints]]
        joints_list.append(j)
    return joints_list


def skeletons_from_logits(joints_list: Sequence[np.ndarray], logits: np.ndarray,
                          max_joints: int, outside_cost: bool = False) -> list:
    """Host Prim MST per mesh from the fetched skelnets output: root = argmax
    root logit, edge cost = -log(sigmoid(pair logit)); with `outside_cost`
    raised for pairs whose segment leaves the volume (the fetched
    inside-fractions) and halved between middle-plane joints."""
    n_pairs = max_joints * (max_joints - 1) // 2
    pairs = pair_table(max_joints)
    skels = []
    for i, joints in enumerate(joints_list):
        J = len(joints)
        root_id = int(np.argmax(logits[i, :J]))
        ok = (pairs[:, 0] < J) & (pairs[:, 1] < J)
        pr = pairs[ok]
        prob = np.zeros((J, J))
        prob[pr[:, 0], pr[:, 1]] = 1.0 / (1.0 + np.exp(
            -logits[i, max_joints:max_joints + n_pairs][ok]))
        prob = prob + prob.T
        cost = -np.log(prob + 1e-10)
        if outside_cost:
            cost = sk.increase_cost_for_outside_bone(
                cost, joints, frac=logits[i, max_joints + n_pairs:][ok])
        parents = sk.prim_mst(cost, root_id)
        skels.append(sk.rig_from_parents(joints, parents))
    return skels


class RigPredictor(torch.nn.Module):
    """The six networks of the rig DAG, on one device."""

    def __init__(self, deform: DeformNet, joint: JointNetMotion, mask: MaskNetMotion,
                 root: RootNet, bone: BoneNet, skin: SkinMotion,
                 cfg: Config = DEFAULT_CONFIG):
        super().__init__()
        self.deform, self.joint, self.mask = deform, joint, mask
        self.root, self.bone, self.skin = root, bone, skin
        self.cfg = cfg
        self.eval()

    @classmethod
    def random(cls, seed: int = 0, device="cuda") -> "RigPredictor":
        """The six networks with every parameter, heads included, filled
        from seeds `seed`..`seed + 5` by `weights.randomize_`, on `device`
        (the card unless the caller asks for another)."""
        return cls(*(randomize_(net(generator=torch.Generator().manual_seed(seed + i)), seed + i)
                     for i, net in enumerate(NET_CLASSES))).to(device)

    @classmethod
    def _from_state_dicts(cls, state_dicts_by_net: dict, device="cuda") -> "RigPredictor":
        """The six networks, built in the current norm mode, from the port's
        state dicts keyed by NETS, loaded with `load_state_dict(strict=True)`,
        on `device`."""
        built = []
        for name, net_cls in zip(NETS, NET_CLASSES):
            net = net_cls()
            net.load_state_dict(state_dicts_by_net[name], strict=True)
            built.append(net)
        return cls(*built).to(device)

    @classmethod
    def from_flax_params(cls, params_by_net: dict, batch_stats_by_net: Optional[dict] = None,
                         device="cuda") -> "RigPredictor":
        """The six networks from flax parameter trees keyed by NETS (e.g. the
        `params` of `train.checkpoint.load_flax_checkpoint` for each stage's
        checkpoint) and, for networks of the "batch" norm mode, their
        `batch_stats` trees, on `device`."""
        stats = batch_stats_by_net or {}
        return cls._from_state_dicts({name: flax_to_state_dict(params_by_net[name], stats.get(name))
                                     for name in NETS}, device)

    @classmethod
    def from_reference(cls, state_dicts_by_net: dict, device="cuda") -> "RigPredictor":
        """The six networks from the reference's PyTorch state dicts keyed by
        NETS, mapped by `eval.torch_import.IMPORTERS`; call
        `nn.mlp.set_default_norm("batch")` first, the only mode they load
        in."""
        return cls._from_state_dicts({name: IMPORTERS[name](state_dicts_by_net[name])
                                     for name in NETS}, device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # -- the single-mesh API ------------------------------------------------
    @torch.no_grad()
    def predict_flow(self, mesh_entry: dict, pts_frames: np.ndarray) -> np.ndarray:
        """pts_frames (T, P, 3) -> flow (V, 3T) from the rest mesh to each
        keyframe: DeformNet on the mesh repeated T times."""
        dev = self.device
        T = pts_frames.shape[0]
        mesh = stack_meshes([mesh_entry] * T, dev)
        points = PointBatch(torch.as_tensor(pts_frames, dtype=torch.float32, device=dev),
                            torch.ones(pts_frames.shape[:2], dtype=torch.bool, device=dev))
        flow = self.deform(mesh, points)[0].cpu().numpy()          # (T, V, 3)
        return np.concatenate([flow[t] for t in range(T)], axis=-1)

    @torch.no_grad()
    def predict_shift_attn(self, mesh_entry: dict, flow: np.ndarray):
        """Shifted points (Vv, 3) and attention (Vv,) of the valid vertices."""
        mesh = stack_meshes([mesh_entry], self.device)
        flow_t = torch.as_tensor(flow[None], dtype=torch.float32, device=self.device)
        shift = self.joint(flow_t, mesh)[2]
        attn_logits = self.mask(flow_t, mesh)[2].cpu().numpy()
        vmask = mesh.vert_mask[0].cpu().numpy()
        shifted = (mesh.verts[0] + torch.tanh(shift[0])).cpu().numpy()[vmask]
        attn = (1.0 / (1.0 + np.exp(-attn_logits[0])))[vmask]
        return shifted, attn.reshape(-1)

    def predict_joints(self, mesh_entry: dict, flow: np.ndarray, vox: Optional[Voxels] = None,
                       shift_attn: Optional[tuple] = None) -> np.ndarray:
        shifted, attn = (shift_attn if shift_attn is not None
                         else self.predict_shift_attn(mesh_entry, flow))
        inside = (lambda p: inside_check_np(p, vox)) if vox is not None else None
        jc = self.cfg.joints
        return extract_joints(
            shifted, attn, inside_fn=inside, bandwidth_quantile=jc.bandwidth_quantile,
            attn_keep_threshold=jc.attn_threshold, density_threshold=jc.density_threshold,
            attn_nms_threshold=jc.attn_nms_threshold, meanshift_iters=jc.meanshift_max_iter,
            bandwidth_sample_rows=jc.bandwidth_sample_rows, device=self.device)

    def predict_skel(self, mesh_entry: dict, joints: np.ndarray,
                     vox: Optional[Voxels] = None) -> sk.Rig:
        return predict_skeleton(mesh_entry, joints, self.root, self.bone, vox=vox)

    @torch.no_grad()
    def predict_skin(self, mesh_entry: dict, skel: sk.Rig, flow: np.ndarray,
                     geo_dist: Optional[np.ndarray] = None) -> sk.Rig:
        """SkinMotion over the K-nearest-bone descriptors, smoothed, pruned
        and assembled into a skinned rig.  `geo_dist` is the (V, B)
        volumetric geodesic; the euclidean point-to-segment distance
        otherwise."""
        dev = self.device
        mesh = stack_meshes([mesh_entry], dev)
        vmask = mesh.vert_mask[0].cpu().numpy()
        bones, _, isleaf = sk.get_bones(skel)
        if geo_dist is None:
            d, _ = point_to_segment_dist(
                mesh.verts, torch.as_tensor(bones[None], dtype=torch.float32, device=dev))
            geo_dist = d[0].cpu().numpy()
        K = self.cfg.model.nearest_bone
        desc, skin_nn, loss_mask = pack_skin_descriptors(geo_dist, bones, isleaf, K)
        flow_t = torch.as_tensor(flow[None], dtype=torch.float32, device=dev)
        logits = self.skin(torch.as_tensor(desc[None], device=dev), flow_t, mesh)[2]
        probs = torch.softmax(logits[0], -1).cpu().numpy()
        full = scatter_skin_full(probs, skin_nn, loss_mask, len(bones))
        sp = self.cfg.skin_post
        smoothed = post_filter_skin(torch.as_tensor(full[None], dtype=torch.float32, device=dev),
                                    mesh.tpl_nbr, mesh.tpl_mask, sp.post_filter_rings)
        pruned = prune_and_normalize(smoothed, sp.prune_ratio_rig)[0].cpu().numpy()
        rig = sk.assemble_skel_skin(skel, pruned[vmask])
        return sk.remove_duplicate_joints(rig)

    def predict_rig(self, mesh_entry: dict, pts_frames: np.ndarray,
                    vox: Optional[Voxels] = None, geo_dist: Optional[np.ndarray] = None,
                    intermediates: Optional[dict] = None,
                    timings: Optional[dict] = None) -> sk.Rig:
        """The whole single-mesh DAG.  With `intermediates={}`, also returns
        there the flow and the shifted points and attention (stage
        byproducts, not recomputed).  With `timings`, adds seconds per stage
        (flow, shift_attn, joints, skel, skin), synchronizing the card at
        each mark."""
        mark = StageTimer(timings, self.device).mark
        flow = self.predict_flow(mesh_entry, pts_frames)
        mark("flow")
        shifted, attn = self.predict_shift_attn(mesh_entry, flow)
        mark("shift_attn")
        if intermediates is not None:
            intermediates.update(flow=flow, shifted=shifted, attn=attn)
        joints = self.predict_joints(mesh_entry, flow, vox, shift_attn=(shifted, attn))
        if len(joints) == 0:  # degenerate fallback: one joint at the centroid
            vmask = np.asarray(mesh_entry["vert_mask"])
            joints = mesh_entry["verts"][vmask].mean(0, keepdims=True)
        mark("joints")
        skel = self.predict_skel(mesh_entry, joints, vox)
        mark("skel")
        rig = self.predict_skin(mesh_entry, skel, flow, geo_dist)
        mark("skin")
        return rig

    # -- device program 1 -------------------------------------------------
    @torch.no_grad()
    def flow_joints(self, mesh_bt: MeshBatch, points: PointBatch, mesh: MeshBatch, T: int,
                    vox=None):
        """Flow (B,V,3T) plus the cluster outputs (moved, bw, counts, attn2,
        sel2) of `select_and_cluster` (with `vox`, the device voxel triple,
        only shifted points inside the volume are clustered)."""
        jc = self.cfg.joints
        vtx_f = self.deform(mesh, None, mesh_only=True)            # once per mesh
        flow_bt = self.deform(mesh_bt, points, vtx_f=vtx_f.repeat_interleave(T, 0))[0]
        Bn, V = mesh.verts.shape[:2]
        # (B*T, V, 3) -> (B, V, 3T), frame-major in the channel
        flow = flow_bt.reshape(Bn, T, V, 3).permute(0, 2, 1, 3).reshape(Bn, V, 3 * T)
        shift = self.joint(flow, mesh)[2]
        attn = self.mask(flow, mesh)[2]
        shifted = mesh.verts + torch.tanh(shift)
        clusters = select_and_cluster(
            shifted, torch.sigmoid(attn[..., 0]), mesh.vert_mask,
            quantile=jc.bandwidth_quantile, num_iter=jc.meanshift_max_iter,
            attn_threshold=jc.attn_threshold, sample_rows=jc.bandwidth_sample_rows, vox=vox)
        return flow, clusters

    # -- device program 2 -------------------------------------------------
    @torch.no_grad()
    def skelnets(self, joints: torch.Tensor, jmask: torch.Tensor, mesh: MeshBatch, vox=None):
        """(B, J + 2P) fp32: [root logits | pair logits | pair inside-fractions]
        over the padded joint slots (the fractions are 1 without voxels)."""
        Bn, J = jmask.shape
        pt = torch.as_tensor(pair_table(J), device=joints.device)
        a, b = joints[:, pt[:, 0]], joints[:, pt[:, 1]]
        dist = torch.linalg.norm(a - b, dim=-1)
        frac = segment_inside_fraction(a, b, *vox) if vox is not None else torch.ones_like(dist)
        root_logits = self.root(mesh, joints, jmask)
        pair_logits = self.bone(mesh, joints, jmask, pt[None].expand(Bn, -1, -1),
                                torch.stack([dist, frac], -1))
        return torch.cat([root_logits[..., 0], pair_logits[..., 0], frac], 1)

    # -- device program 3 -------------------------------------------------
    @torch.no_grad()
    def skin_full(self, bones_packed: torch.Tensor, flow: torch.Tensor, mesh: MeshBatch,
                  vox=None, surf_geo=None):
        """bones_packed (B,M,8) = [6 endpoint coords | isleaf | valid] ->
        pruned skin weights (B,V,M) fp32 over the padded bone axis.  Bone
        distances are euclidean, or volumetric geodesics given the voxel
        triple and the (B,V,V) surface geodesics."""
        K = self.cfg.model.nearest_bone
        sp = self.cfg.skin_post
        bones, isleaf = bones_packed[..., :6], bones_packed[..., 6]
        bmask = bones_packed[..., 7] > 0.5
        Bn, V = mesh.verts.shape[:2]
        if vox is not None and surf_geo is not None:
            d = vertex_bone_geodesic_device(
                mesh.verts, bones, bmask, surf_geo, *vox, num_anchors=sp.geo_anchors,
                los_samples=sp.geo_los_samples, num_candidates=sp.geo_candidates)
        else:
            d, _ = point_to_segment_dist(mesh.verts, bones)        # (B,V,M)
            d = torch.where(bmask[:, None, :], d, torch.full_like(d, 1e30))
        # K nearest, ties to the lower index (lax.top_k order): a stable sort
        dk, nn = torch.sort(d, dim=-1, stable=True)
        dk, nn = dk[..., :K], nn[..., :K]
        ok = torch.gather(bmask[:, None, :].expand(-1, V, -1), 2, nn)
        nn = torch.where(ok, nn, nn[..., :1])                       # repeat nearest
        dk = torch.where(ok, dk, dk[..., :1])
        bsel = torch.arange(Bn, device=bones.device)[:, None, None]
        desc = torch.cat([bones[bsel, nn], (1.0 / (dk + 1e-10))[..., None],
                          isleaf[bsel, nn][..., None]], -1).reshape(Bn, V, K * 8)
        logits = self.skin(desc, flow, mesh)[2]
        probs = torch.softmax(logits, -1) * ok.float()
        full = torch.zeros(Bn, V, bones.shape[1], device=bones.device).scatter_add_(2, nn, probs)
        smoothed = post_filter_skin(full, mesh.tpl_nbr, mesh.tpl_mask, sp.post_filter_rings)
        return prune_and_normalize(smoothed, sp.prune_ratio_rig)

    # -- the DAG -------------------------------------------------------------
    @torch.no_grad()
    def predict_rig_batch(self, mesh_entries: Sequence[dict],
                          pts_frames_list: Sequence[np.ndarray], voxes: Optional[Sequence] = None,
                          surf_geos: Optional[Sequence[np.ndarray]] = None, max_joints: int = 48,
                          timings: Optional[dict] = None, device_cache: Optional[dict] = None,
                          edge_tile: Optional[int] = None) -> list:
        """Rigs for B meshes, each with (T, P, 3) keyframe clouds.

        `voxes` (geometry/voxel.py `Voxels`, one per mesh) are used when every
        mesh has one and they share `dims`: voxel containment in the
        clustering, segment inside-fractions as BoneNet pair attributes and
        the outside-bone MST cost.  `surf_geos` ((n, n) surface geodesics per
        mesh, geometry/geodesic.py `surface_geodesic`) with voxels make the
        skin distances volumetric geodesics.  `edge_tile`: the edge layers
        run on the windowed kernel K5 at this vertex tile when
        `auto_select_edge_impl` chooses it for the batch, on K1 otherwise
        (None: K1).  `device_cache`: a dict that keeps the stacked meshes,
        grids and surface geodesics on the device across calls with the same
        batch; one built from other meshes raises.  With `timings`, adds
        seconds per phase (flow_joints, nms_host, rootbone, mst, skin_device,
        assemble), synchronizing the device at each mark."""
        dev = self.device
        mark = StageTimer(timings, dev).mark

        Bn = len(mesh_entries)
        T = pts_frames_list[0].shape[0]
        cache = device_cache if device_cache is not None else {}
        fp = (batch_fingerprint(Bn, T, mesh_entries), edge_tile)
        if cache.get("_fingerprint", fp) != fp:
            raise ValueError("device_cache was built from another mesh batch; pass a fresh "
                             "cache (or none) when the meshes change")
        cache["_fingerprint"] = fp
        if "mesh_b" not in cache:
            windowed = edge_tile and auto_select_edge_impl(mesh_entries, edge_tile) == "windowed"
            cache["mesh_b"] = stack_meshes(mesh_entries, dev, edge_tile if windowed else None)
            cache["mesh_bt"] = cache["mesh_b"].repeat_interleave(T)
        mesh_b, mesh_bt = cache["mesh_b"], cache["mesh_bt"]
        if ("vox" not in cache and voxes is not None and all(v is not None for v in voxes)
                and len({v.dims for v in voxes}) == 1):
            cache["vox"] = vox_to_device(voxes, dev)
        vox = cache.get("vox")
        # padded rows and columns are "unreachable", so the occluded-pair
        # fallback never routes through a padding vertex; bf16, as the JAX
        # DAG holds it on the device
        if "surf_geo" not in cache and surf_geos is not None and vox is not None:
            V_pad = mesh_entries[0]["verts"].shape[0]
            mats = np.full((Bn, V_pad, V_pad), 1e30, np.float32)
            for i, sg in enumerate(surf_geos):
                n = sg.shape[0]
                mats[i, :n, :n] = np.minimum(sg, 1e30)
            cache["surf_geo"] = torch.as_tensor(mats).to(torch.bfloat16).to(dev)
        surf_geo = cache.get("surf_geo")

        pts = np.concatenate([np.asarray(p, np.float32) for p in pts_frames_list], 0)
        points = PointBatch(torch.as_tensor(pts, device=dev),
                            torch.ones(pts.shape[:2], dtype=torch.bool, device=dev))
        flow, (moved, bw, counts, attn2, sel2) = self.flow_joints(mesh_bt, points, mesh_b, T,
                                                                   vox)
        mark("flow_joints")

        jc = self.cfg.joints
        joints_list = joints_from_clusters(
            [x.cpu().numpy() for x in (moved, bw, counts, attn2, sel2)], mesh_entries,
            max_joints, jc.density_threshold, jc.attn_nms_threshold)
        mark("nms_host")

        joints_p = np.zeros((Bn, max_joints, 3), np.float32)
        jmask = np.zeros((Bn, max_joints), bool)
        for i, j in enumerate(joints_list):
            joints_p[i, :len(j)] = j
            jmask[i, :len(j)] = True
        logits = self.skelnets(torch.as_tensor(joints_p, device=dev),
                               torch.as_tensor(jmask, device=dev), mesh_b, vox).cpu().numpy()
        mark("rootbone")

        skels = skeletons_from_logits(joints_list, logits, max_joints, vox is not None)
        mark("mst")

        raw = [sk.get_bones(s) for s in skels]
        M = bone_slots(max(len(r[0]) for r in raw), max_joints)
        bones_packed = np.zeros((Bn, M, 8), np.float32)
        n_bones = []
        for i, (bones, _, isleaf) in enumerate(raw):
            nb = min(len(bones), M)
            bones_packed[i, :nb, :6] = bones[:nb]
            bones_packed[i, :nb, 6] = isleaf[:nb]
            bones_packed[i, :nb, 7] = 1.0
            n_bones.append(nb)
        pruned = self.skin_full(torch.as_tensor(bones_packed, device=dev), flow, mesh_b, vox,
                                surf_geo).cpu().numpy()
        mark("skin_device")

        rigs = []
        for i in range(Bn):
            vmask = np.asarray(mesh_entries[i]["vert_mask"])
            rig = sk.assemble_skel_skin(skels[i], pruned[i][vmask][:, :n_bones[i]])
            rigs.append(sk.remove_duplicate_joints(rig))
        mark("assemble")
        return rigs


def capsule_predictor(train_steps: int = 12, num_embed_sample: int = 64, seed: int = 0,
                      device="cuda", **fixture_kw):
    """A RigPredictor on `device` over briefly trained stages, on the
    synthetic capsule fixture (num_points=64, n_lat=9, n_lon=8 unless
    `fixture_kw` says otherwise): the six stages' networks from
    `init_state(seed)`, then `train_steps` steps each of the joint, mask,
    bone and root stages on two capsules (the skeleton sample at
    max_joints=8), their draws from one generator seeded seed + 1.  What
    `predict-rig` serves.  Returns (predictor, pose_dataset, rig_dataset)."""
    from morig_tpu_torch.data.pose import capsule_pose_dataset
    from morig_tpu_torch.data.rig import capsule_rig_dataset
    from morig_tpu_torch.data.skeleton_data import capsule_skel_dataset
    from morig_tpu_torch.train.stages import (BoneStage, DeformPoseStage, RigStage, RootStage,
                                              SkinStage)

    kw = dict(num_points=64, n_lat=9, n_lon=8)
    kw.update(fixture_kw)
    pose_ds = capsule_pose_dataset(num_models=2, num_frames=6, **kw)
    rig_ds = capsule_rig_dataset(num_models=2, **kw)
    skel_s = capsule_skel_dataset(num_models=2, max_joints=8, device=device, **kw)
    rig_b = rig_ds.batch([0, 1], device=device)

    stages = dict(deform=DeformPoseStage(),
                  joint=RigStage(arch="jointnet", num_embed_sample=num_embed_sample),
                  mask=RigStage(arch="masknet", num_embed_sample=num_embed_sample),
                  root=RootStage(), bone=BoneStage(),
                  skin=SkinStage(num_embed_sample=num_embed_sample))
    states = {name: stage.init_state(seed, device) for name, stage in stages.items()}
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for _ in range(train_steps):
        for name, batch in (("joint", rig_b), ("mask", rig_b), ("bone", skel_s),
                            ("root", skel_s)):
            stages[name].train_step(states[name], batch, gen)
    return RigPredictor(*(states[name].model for name in NETS)), pose_ds, rig_ds
