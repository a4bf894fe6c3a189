"""Parallel serving helpers, port of ``raft_tpu/parallel``: so far the
fleet's placement layer (``placement.py``). The mesh and partitioner
are ROADMAP M9."""
