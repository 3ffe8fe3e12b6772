"""Checkpoints of the port (`checkpoint.ckpt`), in the reference's layout."""
