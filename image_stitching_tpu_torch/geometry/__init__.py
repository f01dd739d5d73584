"""Rotations, Euler angles, quaternions and the batched camera model."""

from .euler import ORDERS as ALL_ORDERS
from . import quaternion
from .euler import euler_to_rotation_matrix, rotation_matrix_to_euler
from .rotation import (rodrigues_to_matrix, matrix_to_rodrigues, rad_to_deg,
                       deg_to_rad, orthonormalize)
from .camera import Cameras, make_k, get_fov

__all__ = [
    "ALL_ORDERS", "quaternion",
    "euler_to_rotation_matrix", "rotation_matrix_to_euler",
    "rodrigues_to_matrix", "matrix_to_rodrigues", "rad_to_deg", "deg_to_rad",
    "orthonormalize", "Cameras", "make_k", "get_fov",
]
