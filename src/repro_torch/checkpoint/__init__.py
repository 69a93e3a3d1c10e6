"""Content-checksummed checkpoints (``checkpoint.ckpt``)."""
