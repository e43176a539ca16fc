"""Batched rig prediction: rest meshes + point-cloud keyframes -> skinned rigs.

Counterpart of morig_tpu/pipelines/rig_predict.py `predict_rig_batch`,
with or without voxel grids and surface geodesics.  Three device programs
with host work between them:

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
from morig_tpu_torch.geometry import skeleton as sk
from morig_tpu_torch.geometry.bones import point_to_segment_dist
from morig_tpu_torch.geometry.clustering import nms_flip_host, select_and_cluster
from morig_tpu_torch.geometry.geodesic import vertex_bone_geodesic_device
from morig_tpu_torch.geometry.skinning import post_filter_skin, prune_and_normalize
from morig_tpu_torch.geometry.voxel import segment_inside_fraction, vox_to_device
from morig_tpu_torch.nn.bonenet import BoneNet, RootNet
from morig_tpu_torch.nn.deformnet import DeformNet
from morig_tpu_torch.nn.gcu import auto_select_edge_impl
from morig_tpu_torch.nn.rignet import JointNetMotion, MaskNetMotion, SkinMotion
from morig_tpu_torch.weights import randomize_


def batch_fingerprint(Bn: int, T: int, mesh_entries: Sequence[dict]) -> tuple:
    """Content fingerprint of a mesh batch (shapes and cheap checksums, not
    object ids, which CPython reuses) that validates a device cache."""
    def _entry_fp(e):
        v = e["verts"]
        return (v.shape, float(v.sum()), float(np.abs(v).sum()),
                int(e["vert_mask"].sum()), int(e["tpl_nbr"].sum()),
                int(e["geo_nbr"].sum()))

    return (Bn, T, tuple(_entry_fp(e) for e in mesh_entries))


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
        nets = (DeformNet, JointNetMotion, MaskNetMotion, RootNet, BoneNet, SkinMotion)
        return cls(*(randomize_(net(generator=torch.Generator().manual_seed(seed + i)), seed + i)
                     for i, net in enumerate(nets))).to(device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

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
        t_last = [time.perf_counter()]

        def mark(name):
            if timings is None:
                return
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            timings[name] = timings.get(name, 0.0) + now - t_last[0]
            t_last[0] = now

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
