"""Export CLI, port of ``raft_tpu/cli/export.py``: delegates to
``serving.export.main``.

    python -m raft_tpu_torch.cli.export --model raft-small.pth --small \\
        --out raft-small.pt2 [--static_batch] [--device cpu]
"""

from raft_tpu_torch.serving.export import main

if __name__ == "__main__":
    main()
