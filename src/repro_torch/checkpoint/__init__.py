# Checkpoints of the port's states (ckpt.py): the reference's on-disk format.
