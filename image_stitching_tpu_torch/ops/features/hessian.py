"""Multi-scale Hessian detector machinery shared by SURF and AKAZE (port of
`image_stitching_tpu/ops/features/hessian.py`).

Both rank keypoints by the determinant of the Hessian over a scale stack;
SURF builds the stack by Gaussian smoothing, AKAZE by Perona-Malik
diffusion.  Edge padding is replicate padding; the products round as the
reference's XLA CPU contraction does (`imgproc.fma`).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..imgproc import fma

__all__ = ["det_hessian", "diffusion_step", "top_k_keypoints", "edge_pad",
           "central_grad", "stable_top_k"]


def edge_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    """Replicate-pad the last two axes by `pad` (jnp.pad mode="edge")."""
    shape = img.shape
    x = img.reshape(-1, 1, shape[-2], shape[-1])
    out = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    return out.reshape(*shape[:-2], shape[-2] + 2 * pad,
                       shape[-1] + 2 * pad)


def central_grad(img: torch.Tensor):
    """(gx, gy) by central differences over an edge-padded (..., H, W)."""
    p = edge_pad(img, 1)
    gx = 0.5 * (p[..., 1:-1, 2:] - p[..., 1:-1, :-2])
    gy = 0.5 * (p[..., 2:, 1:-1] - p[..., :-2, 1:-1])
    return gx, gy


def det_hessian(img: torch.Tensor) -> torch.Tensor:
    """det(H) = Lxx Lyy - Lxy^2 by central differences at step 2."""
    p = edge_pad(img, 2)
    c = p[2:-2, 2:-2]
    dxx = p[2:-2, 4:] + p[2:-2, :-4] - 2 * c
    dyy = p[4:, 2:-2] + p[:-4, 2:-2] - 2 * c
    dxy = 0.25 * (p[4:, 4:] + p[:-4, :-4] - p[4:, :-4] - p[:-4, 4:])
    return fma(dxx, dyy, -(dxy * dxy))


def diffusion_step(img: torch.Tensor, k_contrast: float = 10.0,
                   tau: float = 0.24) -> torch.Tensor:
    """One explicit Perona-Malik (PM2) diffusion step."""
    p = edge_pad(img, 1)
    gx = 0.5 * (p[1:-1, 2:] - p[1:-1, :-2])
    gy = 0.5 * (p[2:, 1:-1] - p[:-2, 1:-1])
    # XLA divides by the constant k^2 as a product with its reciprocal.
    inv_k2 = torch.tensor(1.0 / (k_contrast * k_contrast),
                          dtype=torch.float32, device=img.device)
    g = 1.0 / fma(fma(gx, gx, gy * gy), inv_k2, 1.0)
    gp = edge_pad(g, 1)
    # The fluxes east, west, south, north, summed as the reference's
    # contraction does: fma(n, ., fma(s, ., fma(e, ., w))).
    w_e, d_e = 0.5 * (gp[1:-1, 2:] + g), p[1:-1, 2:] - img
    flux_w = 0.5 * (gp[1:-1, :-2] + g) * (p[1:-1, :-2] - img)
    w_s, d_s = 0.5 * (gp[2:, 1:-1] + g), p[2:, 1:-1] - img
    w_n, d_n = 0.5 * (gp[:-2, 1:-1] + g), p[:-2, 1:-1] - img
    flux = fma(w_n, d_n, fma(w_s, d_s, fma(w_e, d_e, flux_w)))
    return fma(flux, tau, img)


def stable_top_k(x: torch.Tensor, k: int):
    """Top-k of a flat tensor with lax.top_k's tie order (lower index
    first): (values, int64 indices)."""
    order = torch.sort(x, descending=True, stable=True).indices[:k]
    return x[order], order


def top_k_keypoints(score_maps: List[torch.Tensor], k_total: int,
                    border: int):
    """3x3 NMS per map, then the global top-K over (scale, y, x).

    Returns xy (K, 2), response (K,), scale_idx (K,) int32, valid (K,)."""
    stacked = torch.stack(score_maps)
    s, h, w = stacked.shape
    dev = stacked.device
    pooled = F.max_pool2d(stacked[:, None], 3, stride=1, padding=1)[:, 0]
    nms = torch.where(stacked >= pooled, stacked, 0.0)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    inb = ((yy >= border) & (yy < h - border) & (xx >= border) &
           (xx < w - border))
    nms = torch.where(inb, nms, 0.0)
    vals, idx = stable_top_k(nms.reshape(-1), k_total)
    valid = vals > 0
    sc = (idx // (h * w)).to(torch.int32)
    rem = idx % (h * w)
    ky = (rem // w).to(torch.float32)
    kx = (rem % w).to(torch.float32)
    return torch.stack([kx, ky], -1), vals, sc, valid
