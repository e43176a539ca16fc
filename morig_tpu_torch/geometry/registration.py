"""Rigid registration: batched weighted Kabsch fit and piecewise-RANSAC
tracking — counterpart of morig_tpu/geometry/registration.py.

`kabsch` is batched over any leading axes (`torch.linalg.svd`); the RANSAC
evaluates all of a segment's hypotheses as one batched Kabsch and one error
pass on its generator's device.  Its hypotheses (random correspondence
subsets) come from `PiecewiseRansac.draw`, apart from the fit, so a test
can hand it the JAX package's draws.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def kabsch(src: torch.Tensor, tar: torch.Tensor,
           weights: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-fit rotation and translation per batch entry: src, tar (..., N,
    3), weights (..., N) or None.  Returns (R (..., 3, 3), t (..., 1, 3))
    with tar ~= src @ R^T + t, R a proper rotation."""
    w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device) if weights is None \
        else weights
    wsum = w.sum(-1, keepdim=True)[..., None]
    mu_s = (src * w[..., None]).sum(-2, keepdim=True) / wsum
    mu_t = (tar * w[..., None]).sum(-2, keepdim=True) / wsum
    M = torch.einsum("...na,...nb->...ab", tar - mu_t, (src - mu_s) * w[..., None])
    U, _, Vh = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vh)
    fix = torch.cat([torch.ones(det.shape + (2,), dtype=det.dtype, device=det.device),
                     det[..., None]], -1)
    R = (U * fix[..., None, :]) @ Vh
    t = mu_t - torch.einsum("...ab,...nb->...na", R, mu_s)
    return R, t


def icp_numpy(src_pts: np.ndarray, tar_pts: np.ndarray, device="cuda"):
    """numpy wrapper with the reference's icp signature: (B,N,3) x 2 ->
    (R (B,3,3), t (B,1,3)) float32, computed on `device` (the card unless
    the caller asks for another)."""
    R, t = kabsch(torch.as_tensor(src_pts, dtype=torch.float32, device=device),
                  torch.as_tensor(tar_pts, dtype=torch.float32, device=device))
    return R.cpu().numpy(), t.cpu().numpy()


class PiecewiseRansac:
    """Per-skin-segment rigid RANSAC tracking: each segment's visible handle
    correspondences get a rigid (R, t) from the best of `num_hypotheses`
    random `sample_size` subsets (most inliers within inlier_threshold),
    refit on its inliers when there are at least 3.  Draws come from a
    generator seeded `seed` on `device` (the card unless the caller asks
    for another)."""

    def __init__(self, num_hypotheses: int = 64, sample_size: int = 4,
                 inlier_threshold: float = 0.02, seed: int = 0, device="cuda"):
        self.num_hypotheses = num_hypotheses
        self.sample_size = sample_size
        self.inlier_threshold = inlier_threshold
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def draw(self, n: int) -> torch.Tensor:
        """(num_hypotheses, min(sample_size, n)) correspondence indices in [0, n)."""
        return torch.randint(0, n, (self.num_hypotheses, min(self.sample_size, n)),
                             generator=self.generator, device=self.device)

    def fit_segment(self, src: np.ndarray, tar: np.ndarray):
        """RANSAC rigid fit of one segment's correspondences (N, 3) x 2:
        (R (3,3), t (1,3)) as numpy."""
        if len(src) < 3:
            return np.eye(3), np.zeros((1, 3))
        idx = self.draw(len(src))
        s = torch.as_tensor(src, dtype=torch.float32, device=self.device)
        t_ = torch.as_tensor(tar, dtype=torch.float32, device=self.device)
        R, t = kabsch(s[idx], t_[idx])                                   # (H,3,3), (H,1,3)
        pred = torch.einsum("hab,nb->hna", R, s) + t
        inliers = torch.linalg.vector_norm(pred - t_[None], dim=-1) < self.inlier_threshold
        best = int(torch.argmax(inliers.sum(-1)))
        mask = inliers[best]
        if int(mask.sum()) >= 3:                                         # refit on the consensus
            R2, t2 = kabsch(s[mask][None], t_[mask][None])
            return R2[0].cpu().numpy(), t2[0].cpu().numpy()
        return R[best].cpu().numpy(), t[best].cpu().numpy()

    def run(self, verts: np.ndarray, segments: np.ndarray, handle_src: np.ndarray,
            handle_tar: np.ndarray, handle_seg: np.ndarray) -> np.ndarray:
        """Deform `verts` by per-segment rigid fits: segments (V,) the
        per-vertex segment id (argmax skin weight); handle_* the visible
        correspondence pairs and their segment ids.  Segments with fewer
        than 3 handles stay in place."""
        out = verts.copy()
        for s in np.unique(segments):
            sel = handle_seg == s
            if sel.sum() < 3:
                continue
            R, t = self.fit_segment(handle_src[sel], handle_tar[sel])
            vs = segments == s
            out[vs] = verts[vs] @ R.T + t[0]
        return out
