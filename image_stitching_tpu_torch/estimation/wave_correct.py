"""Wave correction: level the horizon of the camera rotations (port of
`estimation/wave_correct.py`, cv::detail::waveCorrect)."""

from __future__ import annotations

import torch

from ..config import WaveCorrectKind

__all__ = ["wave_correct"]


def _wave_correct_impl(rmats: torch.Tensor, horiz: bool) -> torch.Tensor:
    x_axes = rmats[:, :, 0]
    z_axes = rmats[:, :, 2]
    moment = x_axes.t() @ x_axes
    _, evecs = torch.linalg.eigh(moment)           # ascending, like jnp
    rg1 = evecs[:, 0] if horiz else evecs[:, -1]
    img_k = torch.sum(z_axes, dim=0)
    rg0 = torch.linalg.cross(rg1, img_k)
    rg0 = rg0 / torch.clamp(torch.linalg.norm(rg0), min=1e-12)
    rg2 = torch.linalg.cross(rg0, rg1)
    # Sign fix: the result must not depend on the eigenvector's sign.
    if horiz:
        conf = torch.sum(x_axes @ rg0)
    else:
        conf = -torch.sum(x_axes @ rg1)
    sign = torch.where(conf < 0, -1.0, 1.0).to(rmats.dtype)
    r = torch.stack([rg0 * sign, rg1 * sign, rg2], dim=0)
    return torch.einsum("ij,njk->nik", r, rmats)


def wave_correct(rmats: torch.Tensor,
                 kind: WaveCorrectKind = WaveCorrectKind.HORIZ
                 ) -> torch.Tensor:
    """(N, 3, 3) rotations -> corrected rotations; NO returns the input."""
    if kind == WaveCorrectKind.NO or rmats.shape[0] == 0:
        return rmats
    if kind == WaveCorrectKind.AUTO:
        x_spread = torch.var(rmats[:, :, 0], dim=0, unbiased=False).sum()
        y_spread = torch.var(rmats[:, :, 1], dim=0, unbiased=False).sum()
        return _wave_correct_impl(rmats, bool(x_spread >= y_spread))
    return _wave_correct_impl(rmats, kind == WaveCorrectKind.HORIZ)
