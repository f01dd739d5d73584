"""Camera estimation: components, seeding from the match graph, bundle
adjustment, pose infill, wave correction."""
