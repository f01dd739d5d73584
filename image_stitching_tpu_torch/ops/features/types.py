"""Static-shaped keypoint containers (port of `ops/features/types.py`).

Every image yields exactly `max_features` slots with a validity mask.
Binary descriptors (ORB, AKAZE) are int32 words with the bit pattern of the
reference's uint32 words (torch's uint32 lacks most operators); SIFT and
SURF descriptors are float32.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

__all__ = ["Features"]


@dataclasses.dataclass(frozen=True)
class Features:
    """xy (..., K, 2) f32; response, angle, size (..., K) f32;
    octave (..., K) int32; valid (..., K) bool; desc (..., K, W) int32
    words for binary descriptors (ORB W = 8, AKAZE W = 12) or (..., K, D)
    float32 (SIFT D = 128, SURF D = 64)."""

    xy: torch.Tensor
    response: torch.Tensor
    angle: torch.Tensor
    octave: torch.Tensor
    size: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor

    @property
    def max_features(self) -> int:
        return self.xy.shape[-2]

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32), dim=-1)

    def __getitem__(self, idx) -> "Features":
        return Features(*(getattr(self, f.name)[idx]
                          for f in dataclasses.fields(self)))

    @classmethod
    def stack(cls, feats: Sequence["Features"]) -> "Features":
        return cls(*(torch.stack([getattr(f, fl.name) for f in feats])
                     for fl in dataclasses.fields(cls)))

    @classmethod
    def cat(cls, feats: Sequence["Features"]) -> "Features":
        return cls(*(torch.cat([getattr(f, fl.name) for f in feats])
                     for fl in dataclasses.fields(cls)))
