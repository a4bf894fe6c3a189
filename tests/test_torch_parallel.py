"""The port's parallel layer (``raft_tpu_torch.parallel``) against
``raft_tpu.parallel``, and its data-parallel step across processes.

- The mesh fences and the partitioner, case by case against the JAX
  package's on the conftest's forced 8-device CPU mesh: the grain,
  ``validate_bucket``, ``round_bucket``, ``validate_spatial_extent``'s two
  refusals, ``shard_geometry``, ``mesh_model_config``; the store's
  ``partition_fingerprint`` (``"single"`` without a mesh, one per mesh
  shape, JAX's digest for the same shape and table);
  ``process_batch_slice``'s arithmetic; ``shard_batch``; the serving
  engine on a one-device mesh, and on a larger one what it builds and
  what it refuses (it serves in ``tests/test_torch_spatial.py``).
- Two gloo processes (a ``FileStore`` under the test's directory, each
  with ``jax``, ``flax`` and ``raft_tpu`` blocked, at most 120 s each,
  both killed when one fails) run one basic-model chairs step at 64x64,
  global batch 4, iters 2, ``add_noise`` off, the batch norms trained, and
  valid masks of 90% on rank 0's rows and 30% on rank 1's. Held two ways:
  against the port's one-rank step on the whole batch (loss and metrics
  1e-5 relative: the same sums in another order, and a mean of the ranks'
  means would miss the metrics by far more with these masks; batch-norm
  statistics 1e-5; parameters by ``tests/test_torch_train_step.py``'s
  rule; each rank's weights bitwise the other's), and against JAX's
  ``make_train_step`` on a 2-device mesh with ``split_encode`` on
  (``pallas`` and ``fused``, in interpret mode), with the tolerances of
  ``tests/test_torch_train_step.py`` (a gradient, and the median gap, may
  also differ by twice what one ulp of input does to the port's own).
  Then the same two
  processes train one step through ``training.trainer.train`` on the
  global batch (rank 0 writes): its final ``.pth`` is bitwise their step,
  and held to a one-rank run's.
"""

import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.config import TrainConfig as JaxTrainConfig
from raft_tpu.kernels import corr_pallas, gru_pallas
from raft_tpu.models import RAFT as JaxRAFT
from raft_tpu.parallel import distributed as jax_dist
from raft_tpu.parallel import mesh as jax_mesh
from raft_tpu.parallel import partitioner as jax_part
from raft_tpu.serving.aot import partition_fingerprint as jax_fingerprint
from raft_tpu.tools.convert import convert_state_dict
from raft_tpu.training.train_step import create_train_state as jax_state
from raft_tpu.training.train_step import make_train_step as jax_step
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.parallel import distributed, mesh as port_mesh
from raft_tpu_torch.parallel.partitioner import Partitioner, mesh_model_config
from raft_tpu_torch.serving.aot import partition_fingerprint
from raft_tpu_torch.tools.convert import load_pth, state_dict_from_flax
from raft_tpu_torch.training.train_step import (create_train_state,
                                                make_train_step)
from raft_tpu_torch.training.trainer import train

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SHAPES = [(1, 1), (2, 1), (4, 1), (8, 1), (2, 2), (1, 4), (2, 4)]
WORKER_TIMEOUT_S = 120
KERNELS = dict(corr_impl="pallas", gru_impl="fused")


def _meshes(data, spatial):
    """The port's mesh (rank 0's view) and JAX's, of one shape."""
    n = data * spatial
    port = port_mesh.Mesh(np.asarray(["cpu"] * n, dtype=object).reshape(
        data, spatial), 0, "cpu")
    devs = np.asarray(jax.devices()[:n]).reshape(data, spatial)
    return port, JaxMesh(devs, ("data", "spatial"))


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("refused", str(e).split(";")[0].split(" (")[0][:40])


@pytest.mark.parametrize("shape", SHAPES)
def test_partitioner_geometry_matches_jax(shape):
    port, jmesh = _meshes(*shape)
    p, j = Partitioner(port), jax_part.Partitioner(jmesh)
    assert p.grain() == j.grain()
    assert p.declared_specs() == j.declared_specs()
    for bucket in [(1, 64, 96), (2, 64, 96), (4, 440, 1024), (8, 368, 496),
                   (3, 48, 64), (4, 72, 80), (16, 256, 256)]:
        assert _outcome(p.validate_bucket, bucket) == _outcome(
            j.validate_bucket, bucket), bucket
        assert p.round_bucket(*bucket[:2]) == j.round_bucket(*bucket[:2])
        assert p.shard_geometry(bucket) == j.shard_geometry(bucket)
    for kind in jax_mesh.PARTITION_RULES:
        assert p.spec(kind) == tuple(j.spec(kind))


@pytest.mark.parametrize("spatial,image_h", [
    (1, 8), (2, 64), (2, 72), (2, 48), (2, 16), (4, 128), (4, 96),
    (4, 160), (2, 440)])
def test_spatial_extent_fence_matches_jax(spatial, image_h):
    """Both refusals: feature rows the axis does not divide (72, 160 over
    4, 440 over 2) and shards of at most the 7x7 conv's halo (48, 16, 96
    over 4)."""
    port, jmesh = _meshes(2 if spatial < 4 else 1, spatial)
    got = _outcome(port_mesh.validate_spatial_extent, image_h, port)
    want = _outcome(jax_mesh.validate_spatial_extent, image_h, jmesh)
    assert got[0] == want[0]
    if got[0] == "refused":
        assert got[1][:25] == want[1][:25]
    assert _outcome(Partitioner(port).validate_extent, image_h)[0] == got[0]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kw", [{}, {"small": True},
                                {"split_encode": True}])
def test_mesh_model_config_matches_jax(shape, kw):
    port, jmesh = _meshes(*shape)
    got = mesh_model_config(RAFTConfig(**kw), port)
    want = jax_part.mesh_model_config(JaxConfig(**kw), jmesh)
    assert got.split_encode == want.split_encode


def test_partition_fingerprint_is_single_or_one_per_mesh_shape():
    assert partition_fingerprint() == partition_fingerprint(None) == "single"
    seen = set()
    for shape in SHAPES:
        port, jmesh = _meshes(*shape)
        specs = Partitioner(port).declared_specs()
        fp = partition_fingerprint(port, specs)
        assert fp == jax_fingerprint(
            jmesh, jax_part.Partitioner(jmesh).declared_specs())
        assert fp != partition_fingerprint(port) and fp not in seen
        seen.add(fp)


@pytest.mark.parametrize("global_batch,world", [
    (8, 1), (8, 2), (8, 4), (10, 2), (9, 2), (4, 4), (6, 4)])
def test_process_batch_slice_is_the_same_arithmetic(monkeypatch,
                                                    global_batch, world):
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(distributed, "world_size", lambda: world)
    for r in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(distributed, "rank", lambda r=r: r)
        assert (distributed.process_batch_slice(global_batch)
                == jax_dist.process_batch_slice(global_batch))


def test_shard_batch_moves_one_rank_and_cuts_rows_on_many():
    """``shard_batch`` and ``host_local_batch``: a move on one rank, this
    rank's rows on many, the spatial fence on both."""
    rng = np.random.RandomState(0)
    batch = {"image1": rng.rand(4, 64, 64, 3).astype(np.float32),
             "valid": rng.rand(4, 64, 64).astype(np.float32),
             "scale": np.float32(2.0) * np.ones(3, np.float32)}
    one, _ = _meshes(1, 1)
    out = port_mesh.shard_batch(batch, one)
    assert all(torch.equal(out[k], torch.from_numpy(np.asarray(v)))
               for k, v in batch.items())
    for r in range(2):
        m = port_mesh.Mesh(np.asarray(["cpu", "cpu"], dtype=object).reshape(
            2, 1), r, "cpu")
        out = port_mesh.shard_batch(batch, m)
        assert torch.equal(out["image1"],
                           torch.from_numpy(batch["image1"][2 * r:2 * r + 2]))
        assert torch.equal(out["valid"],
                           torch.from_numpy(batch["valid"][2 * r:2 * r + 2]))
        assert out["scale"].shape == (3,)
        rows = Partitioner(m).sharding("frames")(torch.from_numpy(
            batch["image1"]))
        assert torch.equal(rows, out["image1"])
    rows = {k: v[2:] for k, v in batch.items() if k != "scale"}
    local = distributed.host_local_batch(rows, m)
    assert all(torch.equal(local[k], torch.from_numpy(v))
               for k, v in rows.items())
    sp, _ = _meshes(2, 2)
    with pytest.raises(ValueError, match="halo"):
        distributed.host_local_batch({"image1": np.zeros((2, 48, 32, 3))},
                                     sp)
    with pytest.raises(ValueError, match="halo"):
        port_mesh.shard_batch({"image1": np.zeros((2, 48, 32, 3))}, sp)


def test_engine_serves_from_a_one_device_mesh_and_refuses_a_larger_one(
        tmp_path):
    """A one-device mesh serves bitwise what no mesh serves, under the
    mesh's fingerprint in the store; ``mesh=None`` keeps ``"single"``. A
    mesh of two ranks builds sharded eager programs (they serve in
    ``tests/test_torch_spatial.py``, across processes): its envelope is
    held to the mesh grain, it captures nothing, the store under it
    raises naming ROADMAP.md, and its table adopts into a one-device
    engine."""
    from raft_tpu_torch.serving import RAFTEngine

    torch.set_num_threads(1)
    cfg = RAFTConfig(small=True)
    model = RAFT(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    i1 = (rng.rand(1, 32, 40, 3) * 255).astype(np.uint8)
    i2 = np.roll(i1, 2, axis=2)
    kw = dict(iters=1, envelope=[(1, 32, 40)], device="cpu")
    plain = RAFTEngine(model, cfg, aot_cache=str(tmp_path / "a"), **kw)
    one, _ = _meshes(1, 1)
    meshed = RAFTEngine(model, cfg, mesh=one, aot_cache=str(tmp_path / "b"),
                        **kw)
    assert meshed.partitioner is not None and plain.partitioner is None
    assert plain._aot_key((1, 32, 40))["partition"] == "single"
    assert meshed._aot_key((1, 32, 40))["partition"] == partition_fingerprint(
        one, Partitioner(one).declared_specs())
    np.testing.assert_array_equal(meshed.infer_batch(i1, i2),
                                  plain.infer_batch(i1, i2))
    # a build-on-miss bucket goes through the partitioner's checks
    assert meshed.infer_batch(i1[:, :24], i2[:, :24]).shape == (1, 24, 40, 2)
    two, _ = _meshes(2, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        RAFTEngine(model, cfg, mesh=two, aot_cache=str(tmp_path / "c"), **kw)
    with pytest.raises(ValueError, match="not mesh-divisible"):
        RAFTEngine(model, cfg, mesh=two, **kw)
    sharded = RAFTEngine(model, cfg, mesh=two,
                         **{**kw, "envelope": [(2, 32, 40)]})
    assert sharded.bucket_shapes() == [(2, 32, 40)]
    assert sharded._programs[(2, 32, 40)].graph is None
    assert sharded._programs[(2, 32, 40)].inputs["image1"].shape == (
        1, 32, 40, 3)
    assert sharded.aot_stats()["captures"] == 0
    # a sharded engine's table adopts into a one-device engine, which
    # builds its own program; replicas over ranks are spawned on every
    # rank (tests/test_torch_follow.py)
    assert plain.adopt_executables(sharded) == 1
    assert (2, 32, 40) in plain.bucket_shapes()


def test_train_step_refuses_a_spatial_axis():
    """A ``spatial`` axis over 1 now builds a step (it runs across
    processes in ``tests/test_torch_spatial.py``); a band whose feature
    rows do not exceed the 7x7 conv's halo is refused before any
    collective, with the JAX fence's message."""
    sp, _ = _meshes(1, 2)
    cfg, tc = RAFTConfig(), TrainConfig()
    step = make_train_step(cfg, tc, sp)
    state = create_train_state(RAFT(cfg), tc)
    band = {"image1": np.zeros((1, 24, 32, 3), np.float32),
            "image2": np.zeros((1, 24, 32, 3), np.float32),
            "flow": np.zeros((1, 24, 32, 2), np.float32),
            "valid": np.ones((1, 24, 32), np.float32)}
    with pytest.raises(ValueError, match="halo"):
        step(state, band)
    assert state.step == 0


# -- two processes --------------------------------------------------------

WORKER = """
import json, sys
BLOCKED = ("jax", "flax", "raft_tpu")
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Blocker())
import numpy as np, torch
torch.set_num_threads(1)
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.parallel import distributed
from raft_tpu_torch.parallel.mesh import make_mesh
from raft_tpu_torch.parallel.partitioner import mesh_model_config
from raft_tpu_torch.tools.convert import load_pth
from raft_tpu_torch.training.train_step import (create_train_state,
                                                make_train_step)
from raft_tpu_torch.training.trainer import train
d, r = sys.argv[1], int(sys.argv[2])
distributed.initialize(f"file://{d}/store", 2, r, backend="gloo")
mesh = make_mesh()
assert mesh.shape == {"data": 2, "spatial": 1} and mesh.coords == (r, 0)
cfg = mesh_model_config(RAFTConfig(), mesh)
kw = json.load(open(d + "/train.json"))
tc = TrainConfig(**kw)
batch = dict(np.load(d + "/batch.npz"))
rows = distributed.process_batch_slice(tc.batch_size)
model = load_pth(d + "/weights.pth", cfg)
state = create_train_state(model, tc)
m = make_train_step(cfg, tc, mesh)(state, {k: v[rows]
                                           for k, v in batch.items()})
torch.save({"metrics": {k: float(v) for k, v in m.items()},
            "state": model.state_dict(),
            "grads": {k: p.grad for k, p in model.named_parameters()}},
           f"{d}/rank{r}.pt")
kw.update(num_steps=1, val_freq=1, restore_ckpt=d + "/weights.pth",
          checkpoint_dir=d + "/ckpt2", log_dir=d + "/log2")
train(RAFTConfig(), TrainConfig(**kw), loader=[batch], device="cpu")
print("rank", r, "done", flush=True)
"""

TRAIN_KW = dict(stage="chairs", batch_size=4, image_size=[64, 64], iters=2,
                lr=4e-4, add_noise=False, num_workers=1)


def _batch():
    rng = np.random.RandomState(0)
    im1 = (rng.rand(4, 64, 64, 3) * 255).astype(np.float32)
    im2 = np.roll(im1, (2, 3), axis=(1, 2))
    keep = np.array([0.1, 0.1, 0.7, 0.7])[:, None, None]
    return {"image1": im1, "image2": im2,
            "flow": (3 * rng.randn(4, 64, 64, 2)).astype(np.float32),
            "valid": (rng.rand(4, 64, 64) > keep).astype(np.float32)}


def _run_workers(d):
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, d, str(r)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:         # a rank that failed leaves the other hung
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


def _find_mu(opt_state):
    if hasattr(opt_state, "mu"):
        return opt_state.mu
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            mu = _find_mu(s)
            if mu is not None:
                return mu
    return None


def _jax_two_devices(weights, batch, monkeypatch):
    """JAX's step on a 2-device mesh (``split_encode`` on, as the JAX
    trainer sets it; the Pallas kernels in interpret mode): metrics,
    gradients (after the clip, from Adam's first moment) and the variables
    after."""
    monkeypatch.setattr(corr_pallas, "_INTERPRET", True)
    monkeypatch.setattr(gru_pallas, "_INTERPRET", True)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jmesh = jax_mesh.make_mesh(2)
    jcfg = jax_part.mesh_model_config(JaxConfig(**KERNELS), jmesh)
    img = jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(lambda: JaxRAFT(jcfg).init(
        jax.random.PRNGKey(0), img, img, iters=1))
    jtc = JaxTrainConfig(**{**TRAIN_KW, "image_size": (64, 64)})
    state = jax_state(jcfg, jtc, jax.random.PRNGKey(0),
                      init_variables=convert_state_dict(weights, shapes))
    with jmesh:
        state = jax.device_put(state, jax_mesh.replicated(jmesh))
        new, metrics = jax.jit(jax_step(jcfg, jtc))(
            state, jax_mesh.shard_batch(batch, jmesh), jax.random.PRNGKey(1))
    grads = state_dict_from_flax({"params": jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, _find_mu(new.opt_state))})
    after = state_dict_from_flax({"params": np_tree(new.params),
                                  "batch_stats": np_tree(new.batch_stats)})
    return {k: float(v) for k, v in np_tree(metrics).items()}, grads, after


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    d = str(tmp_path_factory.mktemp("two_ranks"))
    weights = RAFT(RAFTConfig(), torch.Generator().manual_seed(3))
    torch.save(weights.state_dict(), osp.join(d, "weights.pth"))
    batch = _batch()
    np.savez(osp.join(d, "batch.npz"), **batch)
    with open(osp.join(d, "train.json"), "w") as f:
        json.dump(TRAIN_KW, f)
    _run_workers(d)
    ranks = [torch.load(osp.join(d, f"rank{r}.pt")) for r in range(2)]
    # the port's one-rank step on the whole batch
    cfg = RAFTConfig(split_encode=True)
    model = load_pth(osp.join(d, "weights.pth"), cfg)
    tc = TrainConfig(**{**TRAIN_KW, "image_size": (64, 64)})
    metrics = make_train_step(cfg, tc)(create_train_state(model, tc), batch)
    one = {"metrics": {k: float(v) for k, v in metrics.items()},
           "state": model.state_dict(),
           "grads": {k: p.grad for k, p in model.named_parameters()}}
    # the same step on image1 moved by one ulp: what rounding alone does
    # to the gradients at random init
    model = load_pth(osp.join(d, "weights.pth"), cfg)
    make_train_step(cfg, tc)(create_train_state(model, tc), {
        **batch, "image1": np.nextafter(batch["image1"], np.float32(np.inf))})
    ulp_gap = {k: float((p.grad - one["grads"][k]).abs().max())
               for k, p in model.named_parameters()}
    # and one rank through the trainer
    train(RAFTConfig(), TrainConfig(**{
        **TRAIN_KW, "image_size": (64, 64), "num_steps": 1, "val_freq": 1,
        "restore_ckpt": osp.join(d, "weights.pth"),
        "checkpoint_dir": osp.join(d, "ckpt1"),
        "log_dir": osp.join(d, "log1")}), loader=[batch], device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        jax_metrics, jax_grads, jax_after = _jax_two_devices(
            weights.state_dict(), batch, mp)
    torch.set_num_threads(n)
    return dict(dir=d, ranks=ranks, one=one, ulp_gap=ulp_gap,
                jax_metrics=jax_metrics,
                jax_grads=jax_grads, jax_after=jax_after,
                n=batch["valid"].size, lr=TRAIN_KW["lr"] / 25)


def test_two_ranks_end_with_identical_weights(runs):
    a, b = (r["state"] for r in runs["ranks"])
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert runs["ranks"][0]["metrics"] == runs["ranks"][1]["metrics"]


def test_valid_masks_differ_between_the_ranks():
    """The metrics' reduction is tested where a mean of means is wrong."""
    v = _batch()["valid"]
    shares = [v[:2].mean(), v[2:].mean()]
    assert shares[0] > 0.85 and shares[1] < 0.35


@pytest.mark.parametrize("key", ["loss", "epe", "grad_norm", "1px", "3px",
                                 "5px"])
def test_two_ranks_match_one_rank_metrics(runs, key):
    got = runs["ranks"][0]["metrics"][key]
    want = runs["one"]["metrics"][key]
    if key in ("1px", "3px", "5px"):
        assert abs(got - want) <= 2 / runs["n"]
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5 if key != "grad_norm"
                                   else 1e-4)


def _hold_params(state, want, grads, want_grads, lr):
    """``tests/test_torch_train_step.py``'s rule for parameters after one
    AdamW step (its first update is ±lr an element, so an element whose
    gradient is at noise level may move the other way): every element
    within 2·lr + 1e-6; where both gradients agree in sign and exceed 1e-5,
    within 1e-7 + 1e-6·|p|."""
    for k, g in grads.items():
        got, w = state[k].numpy(), want[k].numpy()
        d = np.abs(got - w)
        assert d.max() <= 2 * lr * (1 + 1e-4) + 1e-6, k
        g, wg = g.numpy(), want_grads[k].numpy()
        same = (np.sign(g) == np.sign(wg)) & (np.minimum(np.abs(g),
                                                         np.abs(wg)) > 1e-5)
        assert (d[same] <= 1e-7 + 1e-6 * np.abs(w[same])).all(), k


@pytest.mark.parametrize("part", ["running", "params"])
def test_two_ranks_match_one_rank_state(runs, part):
    """Batch-norm statistics within 1e-5; parameters by
    :func:`_hold_params`."""
    rank, one = runs["ranks"][0], runs["one"]
    if part == "params":
        _hold_params(rank["state"], one["state"], rank["grads"],
                     one["grads"], runs["lr"])
        return
    keys = [k for k in one["state"] if "running_" in k]
    assert keys
    for k in keys:
        torch.testing.assert_close(rank["state"][k], one["state"][k],
                                   atol=1e-5, rtol=0, msg=k)
    assert any(float(one["state"][k].abs().max()) > 1e-3 for k in keys
               if k.endswith("running_mean"))


def test_two_ranks_match_jax_two_devices_metrics(runs):
    got, want = runs["ranks"][0]["metrics"], runs["jax_metrics"]
    assert sorted(got) == sorted(want)
    for k in ("loss", "epe"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    for k in ("1px", "3px", "5px"):
        assert abs(got[k] - want[k]) <= 2 / runs["n"], k


def test_two_ranks_match_jax_two_devices_gradients(runs):
    """``tests/test_torch_train_step.py``'s rule for the basic model (each
    parameter within 5e-2 of its largest gradient, plus 1e-6 of the model's
    largest; the median of those errors within 1e-3), where a parameter
    may also differ by twice the gap one ulp of input opens in the port's
    own gradient of it: on this batch one ulp of image1 moves
    ``fnet.layer3.0.conv1.weight``'s by 8.4% of its largest (a ReLU input
    within rounding of 0, spread over its channel by the instance norm),
    the port against JAX by the same 8.4%; and the median within the
    larger of 1e-3 and twice the median of those one-ulp gaps (3.0e-3 on
    this batch, the port against JAX 3.1e-3: the port's channels-last
    convs take oneDNN's brgemm kernel on the CPU)."""
    grads, want = runs["ranks"][0]["grads"], runs["jax_grads"]
    gmax = max(float(w.abs().max()) for w in want.values())
    rel = {}
    for k, g in grads.items():
        w = want[k]
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        bound = max(5e-2 * scale, 2 * runs["ulp_gap"][k])
        assert err <= bound + 1e-6 * gmax, (k, err, scale)
        if scale > 1e-4 * gmax:
            rel[k] = err / scale
    ulp_median = np.median([runs["ulp_gap"][k] / float(want[k].abs().max())
                            for k in rel])
    assert np.median(list(rel.values())) <= max(1e-3, 2 * ulp_median)


def test_two_ranks_match_jax_two_devices_state(runs):
    """Batch-norm statistics within 1e-5; parameters by
    :func:`_hold_params`."""
    state, after = runs["ranks"][0]["state"], runs["jax_after"]
    for k, want in after.items():
        if "running_" in k:
            np.testing.assert_allclose(state[k].numpy(), want.numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)
    _hold_params(state, after, runs["ranks"][0]["grads"], runs["jax_grads"],
                 runs["lr"])


def test_two_rank_trainer_matches_one_rank_trainer(runs):
    """One step through ``train`` on the global batch, rank 0 writing the
    full state, the weights and the log: the two ranks' final ``.pth`` is
    bitwise their step above, and within :func:`_hold_params` of a
    one-rank ``train`` run's."""
    d = runs["dir"]
    two = torch.load(osp.join(d, "ckpt2", "raft.pth"))
    one = torch.load(osp.join(d, "ckpt1", "raft.pth"))
    step = runs["ranks"][0]["state"]
    assert two.keys() == one.keys() == step.keys()
    for k in two:
        assert torch.equal(two[k], step[k]), k
    _hold_params(two, one, runs["ranks"][0]["grads"], runs["one"]["grads"],
                 runs["lr"])
    assert os.path.isdir(osp.join(d, "ckpt2", "raft", "chairs"))
    assert osp.exists(osp.join(d, "ckpt2", "2_raft.pth"))
    with open(osp.join(d, "log2", "raft", "metrics.jsonl")) as f:
        assert any("train_loop_steps" in json.loads(line) for line in f)
