"""ORB detector/descriptor and the feature containers."""

from .types import Features

__all__ = ["Features"]
