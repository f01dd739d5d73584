"""The feature detector families (orb, akaze, sift, surf) and the
feature containers."""

from .akaze import akaze_detect_and_describe
from .orb import orb_detect_and_describe
from .sift import sift_detect_and_describe
from .surf import surf_detect_and_describe
from .types import Features

__all__ = ["Features", "akaze_detect_and_describe", "orb_detect_and_describe",
           "sift_detect_and_describe", "surf_detect_and_describe"]
