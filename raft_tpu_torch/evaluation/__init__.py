from raft_tpu_torch.evaluation.evaluate import make_forward, resolve_device  # noqa: F401
