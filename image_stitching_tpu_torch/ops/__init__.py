"""Image, feature, matching, warp and blend operators on torch tensors."""
