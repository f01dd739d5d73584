"""Camera estimation: components, bundle adjustment, wave correction."""
