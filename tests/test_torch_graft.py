"""The JAX package's concurrency and wire analysis tiers over the port.

``tools.graftthread`` (lock order, future settles, callbacks, thread
lifecycles, verdict ordering) over ``raft_tpu_torch/serving`` and
``raft_tpu_torch/parallel``, and ``tools.graftwire`` (idempotent remote
calls, wire locks, framed socket I/O, dead-host verdicts) over
``raft_tpu_torch/serving``, both without their caches: no finding. The
port carries the ``GRAFTTHREAD``/``GRAFTWIRE`` declarations of its JAX
counterparts and no inline ``disable`` comment.
"""

import os
import os.path as osp
import subprocess
import sys

import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.mark.parametrize("tool,paths", [
    ("graftthread", ["raft_tpu_torch/serving", "raft_tpu_torch/parallel"]),
    ("graftwire", ["raft_tpu_torch/serving"])])
def test_tier_reports_no_finding(tool, paths):
    r = subprocess.run([sys.executable, "-m", f"tools.{tool}", *paths,
                        "--no-cache"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "finding" not in r.stdout + r.stderr, r.stdout + r.stderr


def test_no_inline_disables():
    for sub in ("serving", "parallel"):
        root = osp.join(REPO, "raft_tpu_torch", sub)
        for f in sorted(os.listdir(root)):
            if f.endswith(".py"):
                text = open(osp.join(root, f)).read()
                for tier in ("graftthread", "graftwire"):
                    assert f"{tier}: disable" not in text, (f, tier)
