"""Checkpoints and compressed artifacts in the reference's on-disk format."""
