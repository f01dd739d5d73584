"""Host layer: logging, native runtime, image IO, EXIF, checkpoints, the
capture rig."""
