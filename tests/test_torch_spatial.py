"""The ``spatial`` mesh axis of the port (height-sharded RAFT across
ranks) against the port unsharded and the JAX package.

Ranks are gloo processes on the CPU, launched as
``tests/test_torch_parallel.py`` launches them: a ``FileStore`` under the
test's directory, ``jax``, ``flax`` and ``raft_tpu`` blocked in each, each
killed after WORKER_TIMEOUT_S, all killed when one fails. Two runs go at
once: a world of 2 (mesh ``(1, 2)``) and one of 4 (meshes ``(1, 4)`` and
``(2, 2)``); each rank runs :func:`worker_main` of this module (which
imports nothing of JAX at the top for that reason), while this process
computes the references.

- Halo units, on ``(1, 2)`` and ``(1, 4)``, 32-row images: every conv
  shape the model has (the stems' 7x7 stride 2, a 3x3 stride 2, the 1x1
  stride-2 downsample, 3x3, the motion encoder's 7x7, the GRU's (5, 1)
  and (1, 5), and the paired (5, 1) conv), the instance, group and batch
  norms over the group, and the fmap2 gather, each held to the unsharded
  op: value, input gradient and the parameters' gradients summed over the
  ranks, within UNIT_TOL of the larger magnitude.
- Forward, on ``(1, 2)`` and ``(1, 4)`` (4 feature rows a band at 128
  rows): the small trained fixture at iters 12 on a 128x64 crop of
  ``demo-frames/`` within SMALL_TOL px of the port unsharded and of JAX's
  ``RAFT``; the basic model at random init, iters 1, within BASIC_TOL px
  of the port unsharded, with the materialized volume and with
  ``alternate_corr``. Each rank's pyramid holds exactly 1/spatial of the
  unsharded pyramid's bytes.
- Train step, on ``(1, 2)`` and ``(2, 2)``, small and basic, 64x64, iters
  2, global batch 4 whose rows have valid shares of 90% and 30%: loss and
  metrics within 1e-5 relative of the port's one-rank step on the whole
  batch (the 1/3/5 px shares within two pixels), gradients within
  ``tests/test_torch_train_step.py``'s rule, every rank's weights bitwise
  equal. The bands sum every conv another way than the whole image, so a
  metric, a parameter's gradient and the gradients' median gap may also
  differ by twice what summing every conv in the NCHW kernel's order does
  to the one-rank step (``tests/conv_order.py``; on the CPU the basic
  model's channels-last weight gradients move by ~2e-3 of a parameter's
  largest at the median). Image noise is on except in the ``(2, 2)``
  small step, which is also held to JAX's ``make_train_step`` on
  ``make_mesh(4, spatial=2)`` with ``corr_impl="onehot"``: its loss within
  1e-4 relative.
- Engine, on ``(2, 2)``: ``RAFTEngine(mesh=)`` on
  ``tests/test_serving.py``'s mesh inputs held to the port's one-device
  engine and to JAX's ``RAFTEngine(mesh=make_mesh(4, spatial=2))`` with
  ``tests/test_serving.py``'s tolerance; a 72-px request builds the bucket
  ``(2, 80, 64)`` and crops back; the warm-start round trip. In this
  process, on a mesh laid out by hand: non-divisible envelope buckets
  raise ``not mesh-divisible`` (as JAX's), and the refusals (feature cache
  and ragged as JAX's; the store naming ROADMAP.md;
  ``forward_ragged``/``forward_cached`` under a band). Replicas and the
  scheduler's ``"shard"`` route over ranks: ``tests/test_torch_follow.py``.
"""

import glob
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.models import raft as raft_module
from raft_tpu_torch.models.layers import (BatchNorm2d, apply_norm, conv,
                                          set_spatial)
from raft_tpu_torch.models.update import _pair_conv
from raft_tpu_torch.parallel import mesh as port_mesh
from raft_tpu_torch.parallel.halo import Spatial, gather_rows

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(REPO, "tests", "fixtures", "raft-small-cputrained")
WORKER_TIMEOUT_S = 120
UNIT_H = 32
UNIT_TOL = 1e-5
FWD_HW = (128, 64)
FWD_ITERS = {"small": 12, "basic": 1, "basic_alt": 1}
SMALL_TOL = 5e-4
BASIC_TOL = 2e-3
TRAIN_HW = (64, 64)
TRAIN_B = 4
ENGINE_ITERS = 2

#: name -> (cin, cout, kernel, stride, padding), every conv geometry of the
#: model: the stems, a stride-2 3x3, the stride-2 downsample, 3x3, the
#: motion encoder's 7x7, the GRU's (5, 1) and (1, 5)
CONVS = {"7x7s2": (3, 4, 7, 2, 3), "3x3s2": (4, 4, 3, 2, 1),
         "1x1s2": (4, 4, 1, 2, 0), "3x3": (4, 4, 3, 1, 1),
         "7x7": (2, 4, 7, 1, 3), "5x1": (4, 4, (5, 1), 1, (2, 0)),
         "1x5": (4, 4, (1, 5), 1, (0, 2))}
UNITS = [*CONVS, "pair5x1", "instance", "group", "batch", "gather"]
#: each world's train-step meshes, ``(data, spatial)``
TRAIN_MESHES = {2: (1, 2), 4: (2, 2)}


def _frames():
    """A 128x64 crop of two consecutive demo frames, (1, H, W, 3) fp32."""
    from raft_tpu_torch.data.png import read_png

    paths = sorted(glob.glob(osp.join(REPO, "demo-frames", "*.png")))[:2]
    h, w = FWD_HW
    return [read_png(p)[150:150 + h, 480:480 + w].astype(np.float32)[None]
            for p in paths]


def _fwd_model(name):
    if name == "small":
        from raft_tpu_torch.tools.convert import load_pth

        return load_pth(FIXTURE + ".pth", RAFTConfig(small=True)).eval()
    cfg = RAFTConfig(alternate_corr=name == "basic_alt")
    return RAFT(cfg, torch.Generator().manual_seed(0)).eval()


def _train_batch():
    """The global batch: rows 0-1 90% valid, rows 2-3 30%."""
    rng = np.random.RandomState(0)
    h, w = TRAIN_HW
    im1 = (rng.rand(TRAIN_B, h, w, 3) * 255).astype(np.float32)
    keep = np.array([0.1, 0.1, 0.7, 0.7])[:, None, None]
    return {"image1": im1, "image2": np.roll(im1, (2, 3), axis=(1, 2)),
            "flow": (3 * rng.randn(TRAIN_B, h, w, 2)).astype(np.float32),
            "valid": (rng.rand(TRAIN_B, h, w) > keep).astype(np.float32)}


def _train_setup(small: bool, noise: bool):
    cfg = RAFTConfig(small=small, split_encode=True)
    tc = TrainConfig(stage="chairs", batch_size=TRAIN_B, image_size=TRAIN_HW,
                     iters=2, lr=4e-4, add_noise=noise, num_workers=1)
    return cfg, tc, RAFT(cfg, torch.Generator().manual_seed(3))


def _train_noise(world: int, small: bool) -> bool:
    """Noise on, except the ``(2, 2)`` small step JAX is held to."""
    return not (world == 4 and small)


def _one_step(small: bool, noise: bool, batch, mesh=None):
    from raft_tpu_torch.training.train_step import (create_train_state,
                                                    make_train_step)

    cfg, tc, model = _train_setup(small, noise)
    m = make_train_step(cfg, tc, mesh)(create_train_state(model, tc), batch)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": model.state_dict(),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()}}


def _conv_order_gap(one, small: bool, noise: bool, batch):
    """What summing every conv in the NCHW kernel's order does to the
    one-rank step ``one``: each metric's relative gap, each parameter's
    largest gradient gap, and the median over the parameters of that gap
    relative to the parameter's largest gradient (those over 1e-4 of the
    model's largest)."""
    from tests.conv_order import nchw_conv_order

    with nchw_conv_order():
        other = _one_step(small, noise, batch)
    gmax = max(float(w.abs().max()) for w in one["grads"].values())
    gap = {k: float((other["grads"][k] - w).abs().max())
           for k, w in one["grads"].items()}
    rel = [gap[k] / float(w.abs().max()) for k, w in one["grads"].items()
           if float(w.abs().max()) > 1e-4 * gmax]
    return {"metrics": {k: abs(other["metrics"][k] - v) / abs(v)
                        for k, v in one["metrics"].items() if v},
            "grads": gap, "median": float(np.median(rel))}


def _engine_inputs():
    """The mesh inputs of ``tests/test_serving.py`` (two 2x64x64 batches),
    a 72-px request and a warm start of 2 px of noise."""
    rng = np.random.RandomState(0)
    return [(rng.rand(2, 64, 64, 3) * 255).astype(np.float32)
            for _ in range(2)] + [
        (rng.rand(1, 72, 64, 3) * 255).astype(np.float32),
        (2 * rng.randn(2, 8, 8, 2)).astype(np.float32)]


def _engine_weights():
    return RAFT(RAFTConfig(small=True), torch.Generator().manual_seed(0))


# -- the ranks ------------------------------------------------------------


def _err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def _scale(b) -> float:
    return max(1.0, float(b.abs().max()) if b.numel() else 0.0)


def _unit(name: str, sp: Spatial, world_group):
    """One unit on this rank's band: ``{part: (error, scale)}`` against
    the op on the whole image, which every rank also computes."""
    import torch.distributed as dist

    gen = torch.Generator().manual_seed(UNITS.index(name))
    rows = UNIT_H // sp.size
    r0 = sp.index * rows
    params = []
    if name in CONVS or name == "pair5x1":
        cin, cout, k, stride, pad = CONVS.get(name, CONVS["5x1"])
        mods = [conv(cin, cout, k, stride, pad)
                for _ in range(2 if name == "pair5x1" else 1)]
        for m in mods:
            with torch.no_grad():
                m.weight.normal_(generator=gen)
                m.bias.normal_(generator=gen)
            params += [m.weight, m.bias]

        def op(x):
            if name == "pair5x1":
                return torch.cat(_pair_conv(mods[0], mods[1], x), 1)
            return mods[0](x)

        def whole(on):
            for m in mods:
                m.spatial = sp if on else None
        x = torch.randn((2, cin, UNIT_H, 8), generator=gen)
    elif name == "gather":
        x = torch.randn((2, UNIT_H, 6, 4), generator=gen)
    else:
        x = 3 * torch.randn((2, 4, UNIT_H, 8), generator=gen) + 1
        if name == "instance":
            norm = nn.InstanceNorm2d(4, eps=1e-5)
        elif name == "group":
            norm = nn.GroupNorm(2, 4, eps=1e-5)
        else:
            norm = BatchNorm2d(4, eps=1e-5)
        if name != "instance":
            with torch.no_grad():
                norm.weight.normal_(generator=gen)
                norm.bias.normal_(generator=gen)
            params += [norm.weight, norm.bias]

        def op(x):
            return apply_norm(norm, x, False)

        def whole(on):
            if name == "batch":
                norm.process_group = world_group if on else None
            else:
                norm.spatial = sp if on else None
    if name == "gather":
        # every rank's cotangent differs: the adjoint sums them
        gys = [torch.randn((2, UNIT_H, 6, 4), generator=gen)
               for _ in range(sp.size)]
        xb = x[:, r0:r0 + rows].clone().requires_grad_(True)
        yb = gather_rows(xb, sp, dim=1)
        (yb * gys[sp.index]).sum().backward()
        want_g = sum(gys)[:, r0:r0 + rows]
        return {"value": (_err(yb, x), _scale(x)),
                "grad": (_err(xb.grad, want_g), _scale(want_g))}
    # the whole image
    whole(False)
    xw = x.clone().requires_grad_(True)
    yw = op(xw)
    gy = torch.randn(yw.shape, generator=gen)
    (yw * gy).sum().backward()
    want_p = [p.grad.clone() for p in params]
    for p in params:
        p.grad = None
    running = ([norm.running_mean.clone(), norm.running_var.clone()]
               if name == "batch" else [])
    if name == "batch":
        norm.reset_running_stats()
    # the band
    whole(True)
    xb = x[:, :, r0:r0 + rows].clone().requires_grad_(True)
    yb = op(xb)
    o = yb.shape[2]
    (yb * gy[:, :, sp.index * o:(sp.index + 1) * o]).sum().backward()
    out = {"value": (_err(yb, yw[:, :, sp.index * o:(sp.index + 1) * o]),
                     _scale(yw)),
           "grad": (_err(xb.grad, xw.grad[:, :, r0:r0 + rows]),
                    _scale(xw.grad))}
    for i, (p, w) in enumerate(zip(params, want_p)):
        g = p.grad.clone()
        dist.all_reduce(g, group=sp.group)
        out[f"param{i}"] = (_err(g, w), _scale(w))
    if name == "batch":
        for i, (got, w) in enumerate(zip(
                [norm.running_mean, norm.running_var], running)):
            out[f"running{i}"] = (_err(got, w), _scale(w))
    return out


def _forward(name: str, mesh):
    """This rank's band of the test-mode forward, and the bytes of the
    pyramid (or the alternate path's fmap2 pyramid) it built."""
    model = _fwd_model(name)
    set_spatial(model, mesh.spatial_context())
    built = []
    real_build = raft_module.build_corr_pyramid
    real_alt = raft_module.AlternateCorrBlock

    def build(*a, **k):
        out = real_build(*a, **k)
        built.append(sum(v.nbytes for v in out))
        return out

    def alt(*a, **k):
        out = real_alt(*a, **k)
        built.append(sum(v.nbytes for v in out.fmap2_pyramid))
        return out

    raft_module.build_corr_pyramid, raft_module.AlternateCorrBlock = build, alt
    try:
        b = mesh.band(FWD_HW[0])
        im1, im2 = (torch.from_numpy(f[:, b["start"]:b["start"] + b["rows"]])
                    for f in _frames())
        with torch.no_grad():
            low, up = model(im1, im2, iters=FWD_ITERS[name])
    finally:
        raft_module.build_corr_pyramid = real_build
        raft_module.AlternateCorrBlock = real_alt
    return {"low": low, "up": up, "pyramid_bytes": built}


def _engine(mesh):
    from raft_tpu_torch.serving import RAFTEngine

    cfg = RAFTConfig(small=True)
    i1, i2, j, finit = _engine_inputs()
    eng = RAFTEngine(_engine_weights(), cfg, iters=ENGINE_ITERS,
                     mesh=mesh, warm_start=True, device="cpu")
    flow, low = eng.infer_batch(i1, i2, return_low=True)
    warm = eng.infer_batch(i1, i2, flow_init=low)
    buckets = eng.bucket_shapes()
    fixed = eng.infer_batch(i1, i2, flow_init=finit)
    miss = eng.infer_batch(j, j)[0]
    return {"flow": flow, "low": low, "warm": warm, "fixed": fixed,
            "buckets": buckets, "miss": miss,
            "miss_buckets": eng.bucket_shapes(), "stats": eng.aot_stats()}


def worker_main(d: str, rank: int, world: int) -> None:
    """One rank of a world of ``world`` gloo processes: every job of that
    world, its results saved to ``d/rank<r>.pt``."""
    from raft_tpu_torch.parallel import distributed
    from raft_tpu_torch.parallel.mesh import make_mesh, shard_batch

    torch.set_num_threads(1)
    distributed.initialize(f"file://{d}/store", world, rank, backend="gloo")
    out = {"units": {}, "forward": {}, "train": {}}
    # every rank makes every mesh, in one order (each makes groups)
    wide = make_mesh(spatial=world)
    meshes = {(1, world): wide}
    data, spatial = TRAIN_MESHES[world]
    if (data, spatial) not in meshes:
        meshes[(data, spatial)] = make_mesh(spatial=spatial)
    sp = wide.spatial_context()
    for name in UNITS:
        out["units"][name] = _unit(name, sp, wide.world_group)
    for name in FWD_ITERS:
        out["forward"][name] = _forward(name, wide)
    mesh = meshes[(data, spatial)]
    for small in (True, False):
        noise = _train_noise(world, small)
        out["train"]["small" if small else "basic"] = _one_step(
            small, noise, shard_batch(_train_batch(), mesh), mesh)
    if world == 4:
        out["engine"] = _engine(mesh)
    torch.save(out, osp.join(d, f"rank{rank}.pt"))


WORKER = """
import sys
BLOCKED = ("jax", "flax", "raft_tpu")
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Blocker())
sys.path.insert(0, sys.argv[1])
import test_torch_spatial
test_torch_spatial.worker_main(sys.argv[2], int(sys.argv[3]),
                               int(sys.argv[4]))
"""


def _start(d: str, world: int):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-c", WORKER, osp.join(REPO, "tests"), d, str(r),
         str(world)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _finish(procs) -> None:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:         # a rank that failed leaves the others hung
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


# -- the references, in this process ---------------------------------------


def _jax_references():
    """JAX's unsharded small fixture forward, its ``(2, 2)`` train step
    and its ``(2, 2)`` engine."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from raft_tpu.config import RAFTConfig as JaxConfig
    from raft_tpu.config import TrainConfig as JaxTrainConfig
    from raft_tpu.evaluation.evaluate import make_forward as jax_forward
    from raft_tpu.models import RAFT as JaxRAFT
    from raft_tpu.parallel import mesh as jax_mesh
    from raft_tpu.parallel import partitioner as jax_part
    from raft_tpu.serving.engine import RAFTEngine as JaxEngine
    from raft_tpu.tools.convert import convert_state_dict
    from raft_tpu.training.train_step import create_train_state as jax_state
    from raft_tpu.training.train_step import make_train_step as jax_step

    out = {}
    with open(FIXTURE + ".msgpack", "rb") as fh:
        variables = jax.tree_util.tree_map(
            jnp.asarray, serialization.msgpack_restore(fh.read()))
    fwd, _ = jax_forward(JaxConfig(small=True), FWD_ITERS["small"])
    out["forward"] = [np.asarray(a) for a in fwd(variables, *_frames())]

    def jax_variables(model, cfg):
        img = jnp.zeros((1, 32, 32, 3))
        shapes = jax.eval_shape(lambda: JaxRAFT(cfg).init(
            jax.random.PRNGKey(0), img, img, iters=1))
        return convert_state_dict(model.state_dict(), shapes)

    jmesh = jax_mesh.make_mesh(4, spatial=2)
    jcfg = jax_part.mesh_model_config(
        JaxConfig(small=True, corr_impl="onehot"), jmesh)
    _, tc, model = _train_setup(True, False)
    jtc = JaxTrainConfig(stage="chairs", batch_size=TRAIN_B,
                         image_size=TRAIN_HW, iters=tc.iters, lr=tc.lr,
                         add_noise=False, num_workers=1)
    state = jax_state(jcfg, jtc, jax.random.PRNGKey(0),
                      init_variables=jax_variables(model, jcfg))
    with jmesh:
        state = jax.device_put(state, jax_mesh.replicated(jmesh))
        _, metrics = jax.jit(jax_step(jcfg, jtc))(
            state, jax_mesh.shard_batch(_train_batch(), jmesh),
            jax.random.PRNGKey(1))
    out["train_loss"] = float(metrics["loss"])

    cfg = JaxConfig(small=True)
    i1, i2, j, _ = _engine_inputs()
    eng = JaxEngine(jax_variables(_engine_weights(), cfg), cfg,
                    iters=ENGINE_ITERS, envelope=[], mesh=jmesh)
    out["engine"] = np.asarray(eng.infer_batch(i1, i2))
    out["engine_miss"] = np.asarray(eng.infer_batch(j, j))
    return out


def _port_references():
    from raft_tpu_torch.serving import RAFTEngine

    out = {"forward": {}, "pyramid_bytes": {}, "train": {},
           "train_witness": {}}
    for name in FWD_ITERS:
        model = _fwd_model(name)
        im1, im2 = (torch.from_numpy(f) for f in _frames())
        with torch.no_grad():
            out["forward"][name] = model(im1, im2, iters=FWD_ITERS[name])
    fmap = _fwd_model("basic")
    h8, w8 = FWD_HW[0] // 8, FWD_HW[1] // 8
    x = torch.zeros((1, h8, w8, fmap.config.fnet_dim))
    out["pyramid_bytes"]["basic"] = sum(
        v.nbytes for v in raft_module.build_corr_pyramid(x, x))
    out["pyramid_bytes"]["basic_alt"] = sum(
        v.nbytes for v in raft_module.AlternateCorrBlock(x, x).fmap2_pyramid)
    batch = _train_batch()
    for small in (True, False):
        for noise in (True, False):
            if small or noise:
                one = out["train"][(small, noise)] = _one_step(small, noise,
                                                               batch)
                out["train_witness"][(small, noise)] = _conv_order_gap(
                    one, small, noise, batch)
    cfg = RAFTConfig(small=True)
    i1, i2, j, finit = _engine_inputs()
    # the sharded engine's buckets, so the fill rows are the same
    eng = RAFTEngine(_engine_weights(), cfg, iters=ENGINE_ITERS,
                     envelope=[(2, 64, 64), (2, 80, 64)], precompile=False,
                     warm_start=True, device="cpu")
    flow, low = eng.infer_batch(i1, i2, return_low=True)
    out["engine"] = {"flow": flow, "low": low,
                     "fixed": eng.infer_batch(i1, i2, flow_init=finit),
                     "miss": eng.infer_batch(j, j)[0]}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    dirs = {w: str(tmp_path_factory.mktemp(f"world{w}")) for w in (2, 4)}
    procs = {w: _start(d, w) for w, d in dirs.items()}
    try:
        port = _port_references()
        jax_ = _jax_references()
    finally:
        for w in procs:
            _finish(procs[w])
        torch.set_num_threads(n)
    ranks = {w: [torch.load(osp.join(d, f"rank{r}.pt"), weights_only=False)
                 for r in range(w)] for w, d in dirs.items()}
    return {"ranks": ranks, "port": port, "jax": jax_}


# -- units ------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", UNITS)
def test_unit_matches_the_whole_image(runs, world, name):
    """Value, input gradient, the parameters' gradients summed over the
    ranks (and the batch norm's running statistics), on every rank."""
    for r, rank in enumerate(runs["ranks"][world]):
        parts = rank["units"][name]
        assert {"value", "grad"} <= set(parts)
        for part, (err, scale) in parts.items():
            assert err <= UNIT_TOL * scale, (r, part, err, scale)


def test_conv_halos_are_the_rows_each_kernel_reads():
    from raft_tpu_torch.parallel.halo import conv_halo

    assert conv_halo(7, 2, 3) == (3, 2)       # the stems
    assert conv_halo(3, 2, 1) == (1, 0)
    assert conv_halo(1, 2, 0) == (0, 0)       # the downsample
    assert conv_halo(7, 1, 3) == (3, 3)       # convf1
    assert conv_halo(5, 1, 2) == (2, 2)       # the GRU's (5, 1)
    assert conv_halo(1, 1, 0) == (0, 0)       # the GRU's (1, 5)


# -- forward ----------------------------------------------------------------


def _whole(ranks, part, key):
    return torch.cat([r["forward"][part][key] for r in ranks], 1)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(FWD_ITERS))
def test_sharded_forward_matches_the_port_unsharded(runs, world, name):
    low, up = runs["port"]["forward"][name]
    tol = SMALL_TOL if name == "small" else BASIC_TOL
    ranks = runs["ranks"][world]
    assert _whole(ranks, name, "up").shape == up.shape
    assert _err(_whole(ranks, name, "up"), up) <= tol
    assert _err(_whole(ranks, name, "low"), low) <= tol
    assert float(up.abs().max()) > 1.0


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_small_fixture_matches_jax_unsharded(runs, world):
    want_low, want_up = runs["jax"]["forward"]
    ranks = runs["ranks"][world]
    np.testing.assert_allclose(_whole(ranks, "small", "up").numpy(),
                               want_up, atol=SMALL_TOL, rtol=0)
    np.testing.assert_allclose(_whole(ranks, "small", "low").numpy(),
                               want_low, atol=SMALL_TOL, rtol=0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["basic", "basic_alt"])
def test_each_rank_holds_its_share_of_the_volume(runs, world, name):
    """The counterpart of ``tests/test_parallel.py``'s temp-memory check:
    a rank's pyramid (the materialized volume's, or the alternate path's
    gathered fmap2 pyramid) is exactly 1/spatial of the whole's; the
    gathered fmap2 pyramid is the whole image's on every rank."""
    whole = runs["port"]["pyramid_bytes"][name]
    for rank in runs["ranks"][world]:
        built = rank["forward"][name]["pyramid_bytes"]
        assert len(built) == 1
        if name == "basic":
            assert built[0] * world == whole
        else:
            assert built[0] == whole


# -- train step -------------------------------------------------------------


def _hold_grads(grads, want, witness):
    """``tests/test_torch_train_step.py``'s rule for the basic model: each
    parameter within 5e-2 of its largest gradient plus 1e-6 of the model's
    largest, the median of those errors within 1e-3; where the
    ``witness`` (:func:`_conv_order_gap`) is larger, a parameter within
    twice its witness gap and the median within twice the witness
    median."""
    gmax = max(float(w.abs().max()) for w in want.values())
    rel = {}
    for k, g in grads.items():
        w = want[k]
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        bound = max(5e-2 * scale, 2 * witness["grads"][k])
        assert err <= bound + 1e-6 * gmax, (k, err, scale)
        if scale > 1e-4 * gmax:
            rel[k] = err / scale
    assert np.median(list(rel.values())) <= max(1e-3, 2 * witness["median"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("model", ["small", "basic"])
def test_spatial_train_step_matches_one_rank(runs, world, model):
    ranks = runs["ranks"][world]
    small = model == "small"
    key = (small, _train_noise(world, small))
    one = runs["port"]["train"][key]
    witness = runs["port"]["train_witness"][key]
    steps = [r["train"][model] for r in ranks]
    for s in steps[1:]:
        assert s["metrics"] == steps[0]["metrics"]
        for k, v in s["state"].items():
            assert torch.equal(v, steps[0]["state"][k]), k
    n = TRAIN_B * TRAIN_HW[0] * TRAIN_HW[1]
    for k, want in one["metrics"].items():
        got = steps[0]["metrics"][k]
        if k in ("1px", "3px", "5px"):
            assert abs(got - want) <= 2 / n, k
        else:
            rtol = max(1e-5, 2 * witness["metrics"].get(k, 0.0))
            np.testing.assert_allclose(got, want, rtol=rtol, err_msg=k)
    _hold_grads(steps[0]["grads"], one["grads"], witness)
    for k, v in one["state"].items():
        if "running_" in k:
            torch.testing.assert_close(steps[0]["state"][k], v, atol=1e-5,
                                       rtol=0, msg=k)


def test_spatial_train_step_matches_jax_on_its_mesh(runs):
    got = runs["ranks"][4][0]["train"]["small"]["metrics"]["loss"]
    np.testing.assert_allclose(got, runs["jax"]["train_loss"], rtol=1e-4)


def test_train_batch_rows_have_different_valid_shares():
    v = _train_batch()["valid"]
    assert v[:2].mean() > 0.85 and v[2:].mean() < 0.35


# -- engine -----------------------------------------------------------------


def test_sharded_engine_matches_one_device_and_jax(runs):
    """``tests/test_serving.py``'s tolerance (atol 0.05, rtol 1e-4), every
    rank returning the whole result."""
    want = runs["port"]["engine"]
    for rank in runs["ranks"][4]:
        e = rank["engine"]
        assert e["flow"].shape == want["flow"].shape == (2, 64, 64, 2)
        np.testing.assert_allclose(e["flow"], want["flow"], atol=0.05,
                                   rtol=1e-4)
        np.testing.assert_allclose(e["flow"], runs["jax"]["engine"],
                                   atol=0.05, rtol=1e-4)
        np.testing.assert_array_equal(e["flow"],
                                      runs["ranks"][4][0]["engine"]["flow"])
        assert e["stats"]["captures"] == 0


def test_sharded_engine_rounds_a_miss_to_the_mesh_grain(runs):
    """A 72-px request (9 feature rows) builds the bucket (2, 80, 64) on a
    (2, 2) mesh and crops back, as JAX's engine does."""
    for rank in runs["ranks"][4]:
        e = rank["engine"]
        assert e["miss"].shape == (72, 64, 2)
        assert (2, 80, 64) in e["miss_buckets"]
        np.testing.assert_allclose(e["miss"], runs["port"]["engine"]["miss"],
                                   atol=0.05, rtol=1e-4)
        np.testing.assert_allclose(e["miss"], runs["jax"]["engine_miss"][0],
                                   atol=0.05, rtol=1e-4)


def test_sharded_engine_warm_start_round_trip(runs):
    """``flow_low`` comes back whole and feeds the next call's warm start;
    warm and cold share one bucket; ``flow_init`` shards with the frames'
    rule: the same warm start gives the one-device engine's result."""
    want = runs["port"]["engine"]
    for rank in runs["ranks"][4]:
        e = rank["engine"]
        assert e["low"].shape == (2, 8, 8, 2)
        assert e["buckets"] == [(2, 64, 64)]
        assert not np.array_equal(e["flow"], e["warm"])
        np.testing.assert_allclose(e["low"], want["low"], atol=0.05,
                                   rtol=1e-4)
        np.testing.assert_allclose(e["fixed"], want["fixed"], atol=0.05,
                                   rtol=1e-4)


def _hand_mesh(data, spatial):
    n = data * spatial
    return port_mesh.Mesh(np.asarray(["cpu"] * n, dtype=object).reshape(
        data, spatial), 0, "cpu")


@pytest.mark.parametrize("bucket", [(1, 64, 64), (2, 68, 64), (2, 64, 64)])
def test_envelope_bucket_must_be_mesh_divisible(bucket):
    """As ``tests/test_serving.py``'s: batch over ``data``, height over
    ``8·spatial``; a divisible bucket builds (no collective until it
    runs)."""
    from raft_tpu_torch.serving import RAFTEngine

    kw = dict(iters=1, envelope=[bucket], mesh=_hand_mesh(2, 2),
              device="cpu")
    if bucket == (2, 64, 64):
        eng = RAFTEngine(_engine_weights(), RAFTConfig(small=True), **kw)
        assert eng.bucket_shapes() == [bucket]
        return
    with pytest.raises(ValueError, match="not mesh-divisible"):
        RAFTEngine(_engine_weights(), RAFTConfig(small=True), **kw)


@pytest.mark.parametrize("what", ["feature_cache", "ragged", "aot_cache"])
def test_multi_rank_engine_refusals(tmp_path, what):
    """Feature-cache and ragged serving raise under a mesh as JAX's do;
    the store raises under a multi-rank mesh, naming ROADMAP.md."""
    from raft_tpu_torch.serving import RAFTEngine

    cfg = RAFTConfig(small=True)
    kw = dict(iters=1, mesh=_hand_mesh(2, 2), device="cpu")
    if what in ("feature_cache", "ragged"):
        flags = ({"feature_cache": True, "warm_start": True}
                 if what == "feature_cache" else {"ragged": True})
        with pytest.raises(ValueError, match="mesh"):
            RAFTEngine(_engine_weights(), cfg, **kw, **flags)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        RAFTEngine(_engine_weights(), cfg, aot_cache=str(tmp_path), **kw)


@pytest.mark.parametrize("which", ["ragged", "cached"])
def test_band_refuses_ragged_and_cached_forwards(which):
    model = RAFT(RAFTConfig(small=True), torch.Generator().manual_seed(0))
    set_spatial(model, Spatial(None, 0, 2))
    x = torch.zeros((1, 32, 32, 3))
    with pytest.raises(ValueError, match="spatial"):
        if which == "ragged":
            v = torch.full((1,), 4, dtype=torch.int32)
            model.forward_ragged(x, x, v, v, iters=1)
        else:
            f = torch.zeros((1, 4, 4, 128))
            model.forward_cached(x, f, torch.zeros((1, 4, 4, 160)),
                                 torch.zeros((1, 4, 4, 2)), iters=1)


def test_without_a_band_every_layer_is_unchanged():
    """``set_spatial(model, None)`` after a band restores the whole-image
    forward bit for bit."""
    model = RAFT(RAFTConfig(small=True), torch.Generator().manual_seed(0))
    x1, x2 = (torch.from_numpy(f[:, :64]) for f in _frames())
    with torch.no_grad():
        want = model(x1, x2, iters=2)
        set_spatial(model, Spatial(None, 0, 2))
        set_spatial(model, None)
        got = model(x1, x2, iters=2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_shard_batch_cuts_rows_and_bands():
    batch = _train_batch()
    batch["flow_init"] = np.random.RandomState(1).rand(
        TRAIN_B, 8, 8, 2).astype(np.float32)
    for r in range(4):
        m = port_mesh.Mesh(np.asarray(["cpu"] * 4, dtype=object).reshape(
            2, 2), r, "cpu")
        out = port_mesh.shard_batch(batch, m)
        d, s = m.coords
        assert m.band(64) == {"start": 32 * s, "rows": 32,
                              "start8": 4 * s, "rows8": 4}
        for k, v in batch.items():
            h = v.shape[1] // 2
            want = v[2 * d:2 * d + 2, h * s:h * (s + 1)]
            assert torch.equal(out[k], torch.from_numpy(
                np.ascontiguousarray(want))), k
    with pytest.raises(ValueError, match="halo"):
        port_mesh.shard_batch({"image1": np.zeros((2, 48, 32, 3))},
                              _hand_mesh(1, 2))
