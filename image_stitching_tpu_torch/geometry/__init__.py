"""Rotations, Euler angles and the batched camera model."""
