"""The stitch pipeline and its fused compose."""
