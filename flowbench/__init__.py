"""The benchmark of raft_tpu_torch on the H100 (see ``flowbench.run``)."""
