"""Synthetic captures with ground truth."""
