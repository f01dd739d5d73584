"""Bundle adjustment by Levenberg-Marquardt (port of
`estimation/bundle_adjust.py`: cv::detail::BundleAdjusterReproj,
BundleAdjusterRay, BundleAdjusterAffinePartial and NoBundleAdjuster).

"reproj" and "ray": seven parameters per camera (focal, ppx, ppy, aspect,
Rodrigues rotation); rotations are always refined, the intrinsics as the
refine mask says.  The reproj residual is the transfer error of each
RANSAC-inlier correspondence through K_b R_b^T R_a K_a^-1, with the
reference's redescending weight (c = 48 px) held constant at each
linearisation point; the ray residual is the difference of the two unit
rays R K^-1 p scaled by sqrt(f_a f_b).  "affine": four parameters per
camera (a, b, tx, ty) of the similarity R holds, residual the transfer
error through A_b^-1 A_a, camera 0 frozen (the gauge), solved by CG.
"no", or an empty problem, returns the seed cameras.

Per-correspondence Jacobians come from forward-mode `torch.func.jvp`
under `vmap`; the normal equations are one dense product (no atomics, so
the sums are deterministic).  The damped system is solved by Cholesky up
to 64 cameras and by Jacobi-preconditioned CG above.  The LM loop runs on
the host, one accept/reject decision per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.func import jvp, vmap

from ..core.logging import count, span
from ..geometry.camera import Cameras, make_k
from ..geometry.rotation import matrix_to_rodrigues, rodrigues_to_matrix

__all__ = ["BAProblem", "pack_correspondences", "bundle_adjust"]

@dataclasses.dataclass
class BAProblem:
    """Packed static-shape correspondence table (numpy)."""
    cam_i: np.ndarray   # (Q,) int32
    cam_j: np.ndarray   # (Q,) int32
    p_i: np.ndarray     # (Q, 2) float32
    p_j: np.ndarray     # (Q, 2) float32
    w: np.ndarray       # (Q,) float32 weights (0 = padding)


def pack_correspondences(xy: np.ndarray, pair_matches, conf_thresh: float,
                         max_per_edge: int = 256,
                         seed: int = 0) -> Optional[BAProblem]:
    """Host-side: inlier correspondences of every computed pair with
    confidence > conf_thresh, at most `max_per_edge` each (seeded
    subsample), padded to a power of two >= 256."""
    conf = np.asarray(pair_matches.confidence)
    a_idx = np.asarray(pair_matches.a_idx)
    b_idx = np.asarray(pair_matches.b_idx)
    inlier = np.asarray(pair_matches.inlier)
    xy = np.asarray(xy)
    rng = np.random.default_rng(seed)
    cam_i, cam_j, p_i, p_j = [], [], [], []
    for p, (i, j) in enumerate(zip(np.asarray(pair_matches.ii),
                                   np.asarray(pair_matches.jj))):
        i, j = int(i), int(j)
        if conf[i, j] <= conf_thresh:
            continue
        rows = np.nonzero(inlier[p])[0]
        if len(rows) == 0:
            continue
        if len(rows) > max_per_edge:
            rows = rng.choice(rows, max_per_edge, replace=False)
        cam_i.append(np.full(len(rows), i, np.int32))
        cam_j.append(np.full(len(rows), j, np.int32))
        p_i.append(xy[i][a_idx[p][rows]])
        p_j.append(xy[j][b_idx[p][rows]])
    if not cam_i:
        return None
    q = sum(len(c) for c in cam_i)
    bucket = 256
    while bucket < q:
        bucket *= 2
    pad = bucket - q
    return BAProblem(
        cam_i=np.pad(np.concatenate(cam_i), (0, pad)),
        cam_j=np.pad(np.concatenate(cam_j), (0, pad), constant_values=1),
        p_i=np.pad(np.concatenate(p_i).astype(np.float32),
                   ((0, pad), (0, 0))),
        p_j=np.pad(np.concatenate(p_j).astype(np.float32),
                   ((0, pad), (0, 0))),
        w=np.pad(np.ones(q, np.float32), (0, pad)))


_ROBUST_C = 48.0


def _affine_residuals(pvec: torch.Tensor, pi: torch.Tensor,
                      pj: torch.Tensor) -> torch.Tensor:
    """Transfer error (Q, 2) of p_i through A_b^-1 A_a, pvec (Q, 8) the two
    cameras' (a, b, tx, ty), A = [[a, -b, tx], [b, a, ty], [0, 0, 1]]."""
    a, b, tx, ty = pvec[:, 0], pvec[:, 1], pvec[:, 2], pvec[:, 3]
    x = a * pi[:, 0] - b * pi[:, 1] + tx
    y = b * pi[:, 0] + a * pi[:, 1] + ty
    a, b, tx, ty = pvec[:, 4], pvec[:, 5], pvec[:, 6], pvec[:, 7]
    det = torch.clamp(a * a + b * b, min=1e-12)
    dx, dy = x - tx, y - ty
    return torch.stack([pj[:, 0] - (a * dx + b * dy) / det,
                        pj[:, 1] - (-b * dx + a * dy) / det], dim=-1)


def _residuals(pvec: torch.Tensor, pi: torch.Tensor, pj: torch.Tensor,
               cost: str = "reproj") -> torch.Tensor:
    """Unweighted residuals given both cameras' parameters per
    correspondence: reproj (Q, 2), ray (Q, 3) from pvec (Q, 14); affine
    (Q, 2) from pvec (Q, 8)."""
    if cost == "affine":
        return _affine_residuals(pvec, pi, pj)
    fa, pxa, pya, aa = pvec[:, 0], pvec[:, 1], pvec[:, 2], pvec[:, 3]
    fb, pxb, pyb, ab = pvec[:, 7], pvec[:, 8], pvec[:, 9], pvec[:, 10]
    ra = rodrigues_to_matrix(pvec[:, 4:7])
    rb = rodrigues_to_matrix(pvec[:, 11:14])
    pa = torch.stack([(pi[:, 0] - pxa) / fa, (pi[:, 1] - pya) / (fa * aa),
                      torch.ones_like(fa)], dim=-1)
    ray = (ra @ pa[..., None])
    if cost == "ray":
        pb = torch.stack([(pj[:, 0] - pxb) / fb,
                          (pj[:, 1] - pyb) / (fb * ab),
                          torch.ones_like(fb)], dim=-1)
        ray2 = (rb @ pb[..., None])[..., 0]
        ray = ray[..., 0]
        d1 = ray / torch.clamp(torch.linalg.norm(ray, dim=-1,
                                                 keepdim=True), min=1e-12)
        d2 = ray2 / torch.clamp(torch.linalg.norm(ray2, dim=-1,
                                                  keepdim=True), min=1e-12)
        return torch.sqrt(torch.abs(fa * fb))[:, None] * (d1 - d2)
    q = (make_k(fb, ab, pxb, pyb) @ (rb.transpose(-1, -2) @ ray))[..., 0]
    qz = torch.where(torch.abs(q[:, 2]) < 1e-12, 1e-12, q[:, 2])
    return torch.stack([pj[:, 0] - q[:, 0] / qz, pj[:, 1] - q[:, 1] / qz],
                       dim=-1)


def _jacobians(pvec: torch.Tensor, pi: torch.Tensor, pj: torch.Tensor,
               cost: str = "reproj") -> torch.Tensor:
    """(Q, R, 2C) Jacobians by forward mode: one jvp per parameter column,
    batched with vmap.  Residual q depends only on row q of pvec, so the
    jvp along column k of every row yields column k of each Jacobian.
    (Forward mode runs on the batched function: per-sample jacfwd over
    0-dim tensors promotes tangents to float64 in torch.func.)"""
    cols = pvec.shape[1]
    basis = torch.eye(cols, dtype=pvec.dtype, device=pvec.device)[:, None, :]
    basis = basis.expand(cols, pvec.shape[0], cols)

    def column(t):
        return jvp(lambda p: _residuals(p, pi, pj, cost), (pvec,), (t,))[1]
    return vmap(column)(basis).permute(1, 2, 0)


def _robust_weight(r: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.sum(r * r, -1) / (_ROBUST_C ** 2),
                       min=0.0)


class _Problem:
    """Device copy of a BAProblem with the LM building blocks; `npar`
    parameters per camera (7, or 4 for the affine cost)."""

    def __init__(self, problem: BAProblem, n_cams: int, free: np.ndarray,
                 device, cost: str = "reproj"):
        def t(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        self.cam_i = t(problem.cam_i, torch.int64)
        self.cam_j = t(problem.cam_j, torch.int64)
        self.p_i = t(problem.p_i, torch.float32)
        self.p_j = t(problem.p_j, torch.float32)
        self.w = t(problem.w, torch.float32)
        self.free = t(free)
        self.n = n_cams
        self.cost_func = cost
        self.npar = 4 if cost == "affine" else 7

    def _pvec(self, params):
        return torch.cat([params[self.cam_i], params[self.cam_j]], dim=1)

    def _weights(self, r):
        """Per-correspondence weights: the robust weight on the reproj
        cost only, times the padding mask."""
        if self.cost_func == "reproj":
            return _robust_weight(r) * self.w
        return self.w

    def cost(self, params) -> torch.Tensor:
        r = _residuals(self._pvec(params), self.p_i, self.p_j,
                       self.cost_func)
        res = r * self._weights(r)[:, None]
        return torch.sum(res * res)

    def normal_eqs(self, params):
        pvec = self._pvec(params)
        r = _residuals(pvec, self.p_i, self.p_j, self.cost_func)
        jac = _jacobians(pvec, self.p_i, self.p_j, self.cost_func)
        wq = self._weights(r)
        res = r * wq[:, None]
        jac = jac * wq[:, None, None]
        q = torch.arange(res.shape[0], device=res.device)
        c = self.npar
        jf = torch.zeros((res.shape[0], res.shape[1], self.n, c),
                         dtype=res.dtype, device=res.device)
        jf[q, :, self.cam_i] = jac[:, :, :c]
        jf[q, :, self.cam_j] += jac[:, :, c:]
        j2 = jf.reshape(-1, self.n * c)
        jtj = j2.t() @ j2
        jtr = j2.t() @ res.reshape(-1)
        free = self.free
        jtj = torch.where(free[:, None] & free[None, :], jtj, 0.0)
        jtj = jtj + torch.diag(torch.where(free, 0.0, 1.0))
        jtr = torch.where(free, jtr, 0.0)
        return torch.sum(res * res), jtj, jtr


def _cg_solve(a: torch.Tensor, b: torch.Tensor, iters: int = 64):
    """Jacobi-preconditioned conjugate gradients for small SPD systems."""
    dinv = 1.0 / torch.clamp(torch.diag(a), min=1e-8)
    x = torch.zeros_like(b)
    r = b
    z = dinv * r
    p = z
    rz = torch.dot(r, z)
    for _ in range(iters):
        ap = a @ p
        alpha = rz / torch.clamp(torch.dot(p, ap), min=1e-20)
        x = x + alpha * p
        r = r - alpha * ap
        z = dinv * r
        rz_new = torch.dot(r, z)
        p = z + rz_new / torch.clamp(rz, min=1e-20) * p
        rz = rz_new
    return x


def _inner_solve(a: torch.Tensor, b: torch.Tensor, solver: str):
    if solver == "chol":
        # 1e-5 jitter bounds the Jacobi-scaled system's condition number
        # against the gauge null space (global rotation).
        a = a + 1e-5 * torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
        chol, info = torch.linalg.cholesky_ex(a)
        if int(info) != 0:
            return torch.full_like(b, float("nan"))
        return torch.cholesky_solve(b[:, None], chol)[:, 0]
    return _cg_solve(a, b)


def _free_mask(n_cams: int, refine_mask: str) -> np.ndarray:
    per_cam = np.zeros(7, bool)
    m = (refine_mask + "_____")[:5]
    per_cam[0] = m[0] == "x"   # focal    (0,0)
    per_cam[1] = m[2] == "x"   # ppx      (0,2)
    per_cam[2] = m[4] == "x"   # ppy      (1,2)
    per_cam[3] = m[3] == "x"   # aspect   (1,1)
    per_cam[4:7] = True        # rotation always refined
    return np.tile(per_cam, n_cams)


def _lm_solve(prob: _Problem, params: torch.Tensor, solver: str,
              max_iters: int) -> torch.Tensor:
    """The LM loop: lambda from 1e-3, x0.3 on an accepted step (floor
    1e-7), x10 on a rejected one, stop at max_iters, lambda >= 1e6 or a
    relative cost decrease below 1e-9."""
    c, jtj, jtr = prob.normal_eqs(params)
    lam = np.float32(1e-3)
    eye = torch.eye(jtj.shape[0], dtype=torch.float32, device=params.device)
    for _ in range(max_iters):
        if lam >= 1e6:
            break
        with span("lm iteration"):
            count("ba.iterations")
            precond = 1.0 / torch.sqrt(torch.clamp(torch.diag(jtj),
                                                   min=1e-8))
            a = jtj * precond[:, None] * precond[None, :] + float(lam) * eye
            step = precond * _inner_solve(a, precond * jtr, solver)
            new_p = params - step.reshape(params.shape)
            new_c = prob.cost(new_p)
            if bool(torch.isfinite(new_c)) and bool(new_c < c):
                converged = bool((c - new_c) < 1e-9 * (1.0 + new_c))
                params = new_p
                lam = max(np.float32(lam * np.float32(0.3)),
                          np.float32(1e-7))
                c, jtj, jtr = prob.normal_eqs(params)
                if converged:
                    break
            else:
                lam = np.float32(lam * np.float32(10.0))
    if not bool(torch.all(torch.isfinite(params))):
        raise RuntimeError("Camera parameters adjusting failed.")
    return params


def _affine_bundle_adjust(cams: Cameras, problem: BAProblem,
                          max_iters: int) -> Cameras:
    """cams.R holds per-camera 3x3 similarities (the affine pipeline):
    LM over their (a, b, tx, ty) with camera 0 frozen, CG-solved."""
    n = len(cams)
    free = np.arange(4 * n) >= 4
    prob = _Problem(problem, n, free, cams.device, cost="affine")
    r = cams.R.to(torch.float32)
    params = torch.stack([r[:, 0, 0], r[:, 1, 0], r[:, 0, 2], r[:, 1, 2]],
                         dim=1)
    out = _lm_solve(prob, params, "cg64", max_iters)
    a, b, tx, ty = out[:, 0], out[:, 1], out[:, 2], out[:, 3]
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    rs = torch.stack([torch.stack([a, -b, tx], -1),
                      torch.stack([b, a, ty], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    return dataclasses.replace(cams, R=rs)


def bundle_adjust(cams: Cameras, problem: Optional[BAProblem],
                  cost_func: str = "reproj", refine_mask: str = "_____",
                  max_iters: int = 25,
                  solver: Optional[str] = None) -> Cameras:
    """LM-refine cameras.  cost_func in {"reproj", "ray", "affine", "no"};
    "no" or an empty problem returns the seed cameras, another cost raises
    ValueError.  Raises RuntimeError on non-finite output ("Camera parameters
    adjusting failed.")."""
    if cost_func == "no" or problem is None:
        return cams
    if cost_func == "affine":
        return _affine_bundle_adjust(cams, problem, max_iters)
    if cost_func not in ("reproj", "ray"):
        raise ValueError(
            f"Unknown bundle adjustment cost function: '{cost_func}'")
    n = len(cams)
    prob = _Problem(problem, n, _free_mask(n, refine_mask), cams.device,
                    cost_func)
    params = torch.cat([cams.focal[:, None], cams.ppx[:, None],
                        cams.ppy[:, None], cams.aspect[:, None],
                        matrix_to_rodrigues(cams.R)], dim=1).to(torch.float32)
    params = _lm_solve(prob, params, solver or ("chol" if n <= 64
                                                else "cg64"), max_iters)
    return Cameras(focal=params[:, 0].contiguous(),
                   aspect=params[:, 3].contiguous(),
                   ppx=params[:, 1].contiguous(),
                   ppy=params[:, 2].contiguous(),
                   R=rodrigues_to_matrix(params[:, 4:7]), t=cams.t)
