"""Weights, configuration and imports of the port.

- The trained small fixture loads into identical port tensors through the
  ``.pth`` directly and through JAX's ``.msgpack`` loader followed by
  ``state_dict_from_flax``; JAX-initialised variables load ``strict=True``.
- ``raft_tpu_torch`` (its ``training``, ``data``, evaluation and serving
  modules, the augmentors, loader, checkpoints and CLIs included),
  ``chip_smoke`` and the ``profile_*.py`` diagnoses import with ``jax``,
  ``flax``, ``raft_tpu``, ``PIL``, ``cv2`` and ``msgpack`` blocked (a
  subprocess; ``raft_tpu_torch`` itself must pass): the card's machine has
  none of them.
- Entry points run on the card unless asked for the CPU, and raise without
  one; configuration validation matches the JAX package's.
"""

import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.models import RAFT as JaxRAFT
from raft_tpu.tools.convert import load_converted
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.evaluation import evaluate
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.tools.convert import (load_pth, load_weights,
                                          state_dict_from_flax)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURES = osp.join(REPO, "tests", "fixtures")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Run the port's CPU ops on one thread: the suite runs in parallel
    workers, and torch's default of one thread per core oversubscribes the
    host for tests that are timing-sensitive."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_both_fixtures_load_into_identical_tensors():
    cfg = RAFTConfig(small=True)
    direct = load_pth(osp.join(FIXTURES, "raft-small-cputrained.pth"), cfg)
    variables = load_converted(
        osp.join(FIXTURES, "raft-small-cputrained.msgpack"),
        JaxConfig(small=True))
    mapped = RAFT(cfg)
    mapped.load_state_dict(
        state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables)),
        strict=True)
    want = direct.state_dict()
    got = mapped.state_dict()
    assert sorted(got) == sorted(want) and len(want) == 106
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("small", [False, True])
def test_jax_init_variables_load_strict(small):
    img = jnp.zeros((1, 32, 32, 3))
    variables = JaxRAFT(JaxConfig(small=small)).init(
        jax.random.PRNGKey(0), img, img, iters=1)
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    model = RAFT(RAFTConfig(small=small))
    model.load_state_dict(sd, strict=True)
    if not small:  # the stride-2 blocks' batch norm is registered twice
        sd = model.state_dict()
        torch.testing.assert_close(
            sd["cnet.layer2.0.downsample.1.running_var"],
            sd["cnet.layer2.0.norm3.running_var"], rtol=0, atol=0)
    k = "update_block.encoder.convc1.weight"
    w = np.asarray(variables["params"]["update_block"]["encoder"]["convc1"]
                   ["kernel"])
    np.testing.assert_array_equal(model.state_dict()[k].numpy(),
                                  w.transpose(3, 2, 0, 1))


_BLOCKER = """
import importlib, pkgutil, sys
BLOCKED = ("jax", "flax", "raft_tpu", "PIL", "cv2", "msgpack")
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Blocker())
import raft_tpu_torch
names = [m.name for m in pkgutil.walk_packages(raft_tpu_torch.__path__,
                                               "raft_tpu_torch.")]
for n in names:
    importlib.import_module(n)
for n in ("training.loss", "training.optim", "training.train_step",
          "training.logger", "training.trainer", "training.checkpoint",
          "kernels.corr_alt", "data.png", "data.frame_utils",
          "data.datasets", "data.augmentor", "data.loader", "ops.interp",
          "utils.ckpt_scan", "evaluation.evaluate", "cli.evaluate",
          "cli._args", "cli.train", "cli.curriculum", "utils.retry",
          "utils.watchdog", "testing.faults", "training.restore_sandbox",
          "training.supervisor", "cli._measure", "cli.loader_bench",
          "cli.envelope", "cli.infer_bench", "cli.corr_bench",
          "cli.profile_step", "cli.trace_summary", "serving",
          "serving.engine", "serving.ragged", "serving.export",
          "cli.export", "cli.parity", "serving.futures", "serving.metrics",
          "serving.trace", "serving.schema", "serving.resilience",
          "serving.feature_cache", "serving.scheduler", "serving.session",
          "parallel.placement", "cli.serve_bench", "cli.serve_trace",
          "serving.registry", "serving.guardian", "serving.aot",
          "serving.transport", "serving.hosts", "serving.host_worker",
          "tools.msgpack", "parallel.distributed", "parallel.mesh",
          "parallel.partitioner", "data.jpeg", "serving.video",
          "testing.avi", "native"):
    assert "raft_tpu_torch." + n in names, n
import chip_smoke, profile_corr_alt, profile_hd_pair, profile_train_convs
import profile_serving_fp32, profile_serving_rows, profile_graph_churn
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names), "modules")
"""


def test_port_and_chip_smoke_import_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", _BLOCKER], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 77


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RAFTConfig(small=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.make_forward(cfg, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.make_forward(cfg, 2, device="cuda")
    fwd, _ = evaluate.make_forward(cfg, 1, device="cpu")
    img = np.zeros((1, 64, 64, 3), np.float32)
    lo, up = fwd(RAFT(cfg), img, img)
    assert lo.device.type == "cpu" and up.shape == (1, 64, 64, 2)
    # a 32x64 image: the pyramid's last level is empty and reads as zeros
    lo, up = fwd(RAFT(cfg), img[:, :32], img[:, :32])
    assert up.shape == (1, 32, 64, 2) and bool(torch.isfinite(up).all())
    from raft_tpu_torch.cli.demo import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model", "unused.pth", "--path", REPO, "--small"])


@pytest.mark.parametrize("kw", [
    {}, {"small": True}, {"corr_impl": "pallas", "gru_impl": "fused"},
    {"corr_impl": "onehot_t"}, {"corr_dtype": "bfloat16"},
    {"corr_impl": "mosaic"}, {"gru_impl": "fused", "small": True},
    {"gru_impl": "cuda"}, {"corr_dtype": "float16"}, {"scan_unroll": 0},
    {"remat_policy": "some"}, {"alternate_corr": True,
                               "corr_dtype": "bfloat16"}])
def test_config_validation_matches_jax(kw):
    def outcome(cls):
        try:
            c = cls(**kw)
        except ValueError:
            return "rejected"
        return (c.hidden_dim, c.context_dim, c.corr_radius, c.fnet_dim,
                c.cnet_dim, c.fnet_norm, c.cnet_norm, c.corr_planes)

    assert outcome(RAFTConfig) == outcome(JaxConfig)


def test_later_slices_raise_not_implemented(tmp_path):
    from raft_tpu_torch.data.frame_utils import read_gen
    from raft_tpu_torch.ops.interp import forward_interpolate_device

    # mixed precision, dropout, training's augmentation, the serving
    # layer's on-device warm start and JPEG frames are ported
    from raft_tpu_torch.data.jpeg import write_jpeg
    RAFT(RAFTConfig(mixed_precision=True))
    frame = np.full((9, 11, 3), 77, np.uint8)
    write_jpeg(str(tmp_path / "frame.jpg"), frame)
    np.testing.assert_array_equal(read_gen(str(tmp_path / "frame.jpg")),
                                  frame)
    assert not forward_interpolate_device(torch.zeros(8, 8, 2)).any()
    model = RAFT(RAFTConfig(small=True, dropout=0.1))
    img = torch.zeros(1, 32, 32, 3)
    model(img, img, iters=1, test_mode=False, train=True)
    # the serving forwards (M10), the front end (M11a), the registry and
    # the replica fleet (M11b), the program store and the host lanes
    # (M11c), a mesh (M9) with follower ranks (the "shard" route and
    # replicas over ranks), .msgpack weights (M1) and the serving video
    # (M14) are ported; the store under a multi-rank mesh is not
    full = torch.full((1,), 4, dtype=torch.int32)
    assert model.forward_ragged(img, img, full, full, iters=1)[1].shape == (
        1, 32, 32, 2)
    cached = model.forward_cached(img, torch.zeros(1, 4, 4, 128),
                                  torch.zeros(1, 4, 4, 160),
                                  torch.zeros(1, 4, 4, 2), iters=1)
    assert [tuple(t.shape) for t in cached] == [
        (1, 4, 4, 2), (1, 32, 32, 2), (1, 4, 4, 128), (1, 4, 4, 160)]
    from raft_tpu_torch.cli.parity import main as parity
    from raft_tpu_torch.serving import RAFTEngine
    from raft_tpu_torch.parallel.mesh import Mesh
    two = Mesh(np.asarray(["cpu", "cpu"], dtype=object).reshape(2, 1), 0,
               "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        RAFTEngine(model, model.config, mesh=two,
                   aot_cache=str(tmp_path / "meshed"), device="cpu")
    with pytest.raises(TypeError):
        RAFTEngine(model, model.config, mesh=object(), device="cpu")
    eng = RAFTEngine(model, model.config, aot_cache=str(tmp_path),
                     device="cpu")
    assert eng.aot_stats()["enabled"] == 1
    with pytest.raises(ValueError, match="fewer than two frames"):
        parity(["--model", osp.join(FIXTURES, "raft-small-cputrained.pth"),
                "--small", "--path", str(tmp_path),
                "--video", str(tmp_path / "out.avi"), "--device", "cpu"])
    from raft_tpu_torch.serving import (HostFleet, HostWorker,
                                        LoopbackTransport,
                                        MicroBatchScheduler, ModelRegistry)
    fleet = HostFleet({"h0": LoopbackTransport(HostWorker(eng))})
    fleet.admit_all()
    with MicroBatchScheduler(eng, host_fleet=fleet) as sched:
        assert sched.health()["hosts"]["state"] == "healthy"
    reg = ModelRegistry(device="cpu")
    reg.add_model("m", model.state_dict(), model.config,
                  artifact_dir=str(tmp_path))
    assert reg._models["m"].live.engine.aot_stats()["enabled"] == 1
    reg.close()
    import os

    import raft_tpu_torch
    for root, _, files in os.walk(raft_tpu_torch.__path__[0]):
        for f in files:
            if f.endswith(".py"):
                assert "M11c" not in open(os.path.join(root, f)).read(), f
    weights = load_weights(osp.join(FIXTURES, "raft-small-cputrained.msgpack"),
                           RAFTConfig(small=True))
    assert isinstance(weights, RAFT)
