"""Training, port of ``raft_tpu/training``: the sequence losses, AdamW with
OneCycle and the optax-form clip, one train step and the loop around it."""
