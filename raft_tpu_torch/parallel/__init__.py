"""Parallel runs, port of ``raft_tpu/parallel``: the processes of a
data-parallel run (``distributed.py``), their mesh (``mesh.py``), the
partitioner that owns the sharding decisions (``partitioner.py``) and the
serving fleet's placement layer (``placement.py``)."""
