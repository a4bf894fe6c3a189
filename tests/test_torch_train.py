"""The port's training pieces against the JAX package on the CPU.

- ``convex_upsample_batched_raw``, the subpixel transforms and
  ``upflow8_batched`` against JAX's, within 1e-6 (flows of spread 0.1, so
  every output is O(1), where 1e-6 is a few fp32 ulps).
- Both sequence losses and their metrics against JAX's, within 1e-6.
- Batch norm in train mode against flax's ``BatchNorm`` with
  ``mutable=["batch_stats"]``: output and input gradient within 1e-5
  (flax takes the variance as E[x²]−E[x]², the port in two passes), new
  running statistics within 1e-6.
- The OneCycle schedule at its phase boundaries against JAX's within 1e-6
  relative plus 1e-10 (JAX evaluates it in fp32: an ulp of the peak lr
  is 2.4e-11), and one AdamW + clip update against ``optax`` within 1e-7
  relative (above and below the clip norm).
- ``train()`` end to end on the CPU from the trained small fixture: two
  steps on an in-memory loader; the ``.pth`` it writes loads into the port
  with ``strict=True`` and into JAX through ``raft_tpu.tools.convert``,
  and both give the same test-mode flow within 5e-4 px (the ROADMAP's
  end-to-end bound).
- What later slices port raises ``NotImplementedError`` naming its item.
"""

import glob
import json
import os
import os.path as osp
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.evaluation.evaluate import make_forward as jax_make_forward
from raft_tpu.kernels import corr_pallas
from raft_tpu.models.layers import Norm
from raft_tpu.ops import flow_ops as jflow
from raft_tpu.tools.convert import load_pth as jax_load_pth
from raft_tpu.training import loss as jloss
from raft_tpu.training.optim import make_optimizer as jax_make_optimizer
from raft_tpu_torch.config import RAFTConfig, TrainConfig, stage_config
from raft_tpu_torch.evaluation.evaluate import make_forward
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.models.layers import BatchNorm2d
from raft_tpu_torch.ops import flow_ops
from raft_tpu_torch.tools.convert import load_pth
from raft_tpu_torch.training import loss, optim
from raft_tpu_torch.training.train_step import (add_noise, create_train_state,
                                                make_train_step,
                                                step_generator)
from raft_tpu_torch.training.trainer import train

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(REPO, "tests", "fixtures", "raft-small-cputrained.pth")
FRAMES = sorted(glob.glob(osp.join(REPO, "demo-frames", "*.png")))


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Run the port's CPU ops on one thread: the suite runs in parallel
    workers, and torch's default of one thread per core oversubscribes the
    host for tests that are timing-sensitive."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_batched_upsample_and_subpixel_transforms_match_jax():
    rng = np.random.RandomState(0)
    T, B, H, W = 3, 2, 4, 6
    flows = (0.1 * rng.randn(T, B, H, W, 2)).astype(np.float32)
    masks = rng.randn(T, B, H, W, 576).astype(np.float32)
    want = np.asarray(jflow.convex_upsample_batched_raw(jnp.asarray(flows),
                                                        jnp.asarray(masks)))
    got = flow_ops.convex_upsample_batched_raw(_t(flows), _t(masks))
    assert got.shape == (T, B, 2, 64, H * W)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        flow_ops.subpixel_to_standard(_t(want), H, W).numpy(),
        np.asarray(jflow.subpixel_to_standard(jnp.asarray(want), H, W)))
    img = rng.randn(B, 8 * H, 8 * W, 3).astype(np.float32)
    np.testing.assert_array_equal(
        flow_ops.standard_to_subpixel(_t(img)).numpy(),
        np.asarray(jflow.standard_to_subpixel(jnp.asarray(img))))
    np.testing.assert_allclose(
        flow_ops.upflow8_batched(_t(flows)).numpy(),
        np.asarray(jflow.upflow8_batched(jnp.asarray(flows))), atol=1e-6,
        rtol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_sequence_losses_match_jax(fused):
    """A tenth of the ground truth at or above MAX_FLOW, half the pixels
    invalid (valid < 0.5); flows of spread 1, so the loss is O(1)."""
    rng = np.random.RandomState(1)
    T, B, H, W = 3, 2, 4, 6
    gt = rng.randn(B, 8 * H, 8 * W, 2).astype(np.float32)
    gt[rng.rand(B, 8 * H, 8 * W) < 0.1] = 450.0
    valid = rng.rand(B, 8 * H, 8 * W).astype(np.float32)
    if fused:
        preds = rng.randn(T, B, 2, 64, H * W).astype(np.float32)
        jfn, fn = jloss.sequence_loss_subpixel, loss.sequence_loss_subpixel
    else:
        preds = rng.randn(T, B, 8 * H, 8 * W, 2).astype(np.float32)
        jfn, fn = jloss.sequence_loss, loss.sequence_loss
    jl, jm = jfn(jnp.asarray(preds), jnp.asarray(gt), jnp.asarray(valid), 0.8)
    gl, gm = fn(_t(preds), _t(gt), _t(valid), 0.8)
    np.testing.assert_allclose(float(gl), float(jl), atol=1e-6, rtol=0)
    assert sorted(gm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(gm[k]), float(jm[k]), atol=1e-6,
                                   rtol=0, err_msg=k)


def test_train_mode_batch_norm_matches_flax():
    """32 samples of 8 channels, running statistics from a non-trivial
    start: the new running variance is 0.9·old + 0.1·(biased batch
    variance), as flax computes it, not torch's unbiased one."""
    rng = np.random.RandomState(2)
    x = (2 + 3 * rng.randn(2, 4, 4, 8)).astype(np.float32)
    G = rng.randn(2, 4, 4, 8).astype(np.float32)
    mean0 = rng.randn(8).astype(np.float32)
    var0 = (1 + rng.rand(8)).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(8)).astype(np.float32)
    bias = (0.1 * rng.randn(8)).astype(np.float32)
    variables = {"params": {"norm": {"scale": jnp.asarray(scale),
                                     "bias": jnp.asarray(bias)}},
                 "batch_stats": {"norm": {"mean": jnp.asarray(mean0),
                                          "var": jnp.asarray(var0)}}}
    norm = Norm("batch", 8)

    def f(xx):
        out, upd = norm.apply(variables, xx, use_running_average=False,
                              mutable=["batch_stats"])
        return jnp.sum(out * G), (out, upd)

    (_, (want, upd)), want_dx = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x))

    bn = BatchNorm2d(8, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
        bn.running_mean.copy_(_t(mean0))
        bn.running_var.copy_(_t(var0))
    xt = _t(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    out = bn(xt, use_running_average=False)
    (out * _t(G).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_dx), atol=1e-5, rtol=0)
    stats = upd["batch_stats"]["norm"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]),
                               atol=1e-6, rtol=0)
    biased = x.reshape(-1, 8).var(0)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * var0 + 0.1 * biased,
                               rtol=1e-5)
    # use_running_average=True normalizes with the buffers and leaves them
    before = bn.running_var.clone()
    ev = bn(xt.detach(), use_running_average=True)
    torch.testing.assert_close(bn.running_var, before, rtol=0, atol=0)
    want_ev = ((xt.detach() - bn.running_mean[:, None, None])
               / torch.sqrt(bn.running_var[:, None, None] + 1e-5)
               * bn.weight[:, None, None] + bn.bias[:, None, None])
    torch.testing.assert_close(ev, want_ev, rtol=1e-5, atol=1e-5)


def test_onecycle_schedule_matches_jax_at_phase_boundaries():
    lr, num_steps = 4e-4, 1000
    _, schedule = jax_make_optimizer(lr, num_steps)
    p = torch.nn.Parameter(torch.zeros(1))
    opt, sched = optim.make_optimizer([p], lr, num_steps)
    total = num_steps + 100
    warm_end = int(0.05 * total) - 1
    boundaries = {0, 1, warm_end - 1, warm_end, warm_end + 1, total // 2,
                  total - 2, total - 1}
    got = {}
    for step in range(total):
        if step in boundaries:
            got[step] = opt.param_groups[0]["lr"]
        opt.step()
        sched.step()
    for step, value in sorted(got.items()):
        np.testing.assert_allclose(value, float(schedule(step)), rtol=1e-6,
                                   atol=1e-10, err_msg=f"step {step}")
    assert got[warm_end] == pytest.approx(lr)


@pytest.mark.parametrize("grad_scale", [10.0, 0.01])
def test_adamw_and_clip_update_matches_optax(grad_scale):
    """One update from a fresh optimizer, with the global norm above
    (clipped) and below (left alone) the clip of 1.0."""
    rng = np.random.RandomState(3)
    params = {"a": rng.randn(4, 5).astype(np.float32),
              "b": rng.randn(7).astype(np.float32)}
    grads = {k: (grad_scale * rng.randn(*v.shape) / 5).astype(np.float32)
             for k, v in params.items()}
    tx, _ = jax_make_optimizer(4e-4, 100, 1e-4, 1e-8, 1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    updates, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                           tx.init(jp), jp)
    want = optax.apply_updates(jp, updates)

    tp = [torch.nn.Parameter(_t(params[k]).clone()) for k in ("a", "b")]
    for p, k in zip(tp, ("a", "b")):
        p.grad = _t(grads[k]).clone()
    opt, _ = optim.make_optimizer(tp, 4e-4, 100, 1e-4, 1e-8)
    norm = optim.clip_by_global_norm_([p.grad for p in tp], 1.0)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                               rtol=1e-6)
    opt.step()
    for p, k in zip(tp, ("a", "b")):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]),
                                   rtol=1e-7, atol=1e-9)


def test_noise_replays_by_seed_and_step():
    """The noise cannot match JAX's bits: the same (seed, step) gives the
    same batch, another step or another seed another one, stdv within
    [0, 5] and pixels clipped to [0, 255]."""
    rng = np.random.RandomState(4)
    im = _t((rng.rand(2, 16, 16, 3) * 255).astype(np.float32))
    a = add_noise(im, im, step_generator(1234, 7, "cpu"))
    b = add_noise(im, im, step_generator(1234, 7, "cpu"))
    c = add_noise(im, im, step_generator(1234, 8, "cpu"))
    d = add_noise(im, im, step_generator(99, 7, "cpu"))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    assert not torch.equal(a[0], d[0])
    for x in a + c:
        assert float(x.min()) >= 0 and float(x.max()) <= 255
    stdv = 5 * torch.rand((), generator=step_generator(1234, 7, "cpu"))
    assert 0 <= float(stdv) <= 5
    inner = (im > 30) & (im < 225)   # unclipped pixels carry the noise
    assert float((a[0] - im)[inner].std()) == pytest.approx(float(stdv),
                                                            rel=0.1)


class Loader:
    """Two in-memory batches of uint8 frames (the loader's wire format)
    cropped from the demo frames, a constant ground-truth shift."""

    def __init__(self):
        from PIL import Image

        frames = [np.asarray(Image.open(f).convert("RGB"))
                  for f in FRAMES[:3]]
        self.batches = []
        for top, left in ((186, 448), (120, 300)):
            im1 = np.stack([f[top:top + 64, left:left + 128]
                            for f in frames[:2]])
            im2 = np.stack([f[top:top + 64, left:left + 128]
                            for f in frames[1:3]])
            self.batches.append({
                "image1": im1, "image2": im2,
                "flow": np.full((2, 64, 128, 2), 1.5, np.float32),
                "valid": np.ones((2, 64, 128), np.uint8)})

    def __iter__(self):
        return iter(self.batches)


def test_train_end_to_end_on_cpu_writes_pth_that_both_packages_load(tmp_path):
    cfg = RAFTConfig(small=True)
    tc = stage_config("chairs", name="e2e", batch_size=2, image_size=(64, 128),
                      iters=2, num_steps=2, sum_freq=2, validation=(),
                      restore_ckpt=FIXTURE,
                      checkpoint_dir=str(tmp_path / "ckpt"),
                      log_dir=str(tmp_path / "runs"))
    state = train(cfg, tc, loader=Loader(), device="cpu")
    assert state.step == 2
    path = tmp_path / "ckpt" / "e2e.pth"
    assert path.exists()
    records = [json.loads(line) for line in
               open(tmp_path / "runs" / "e2e" / "metrics.jsonl")]
    assert records and set(records[0]) >= {"loss", "epe", "1px", "3px", "5px"}
    port = load_pth(str(path), cfg)                # strict=True
    start = load_pth(FIXTURE, cfg)
    moved = [not torch.equal(a, b) for a, b in zip(
        port.state_dict().values(), start.state_dict().values())]
    assert any(moved)

    im1 = np.stack(Loader().batches[0]["image1"][:1]).astype(np.float32)
    im2 = np.stack(Loader().batches[0]["image2"][:1]).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(corr_pallas, "_INTERPRET", True)
        variables = jax_load_pth(str(path), JaxConfig(small=True))
        jfwd, _ = jax_make_forward(JaxConfig(small=True), 12)
        want = [np.asarray(a) for a in jfwd(variables, im1, im2)]
    fwd, _ = make_forward(cfg, 12, device="cpu")
    got = [a.numpy() for a in fwd(port, im1, im2)]
    assert np.abs(want[1]).max() > 0.5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=0)


def test_uint8_wire_gives_the_float_step():
    """The step casts the uint8 wire format on the device: an integral
    float32 batch and its uint8 twin give the same step."""
    cfg = RAFTConfig(small=True)
    tc = TrainConfig(batch_size=2, image_size=(64, 128), iters=1)
    u8 = Loader().batches[0]
    f32 = {k: v.astype(np.float32) for k, v in u8.items()}
    out = []
    for batch in (u8, f32):
        model = RAFT(cfg)
        metrics = make_train_step(cfg, tc)(create_train_state(model, tc), batch)
        out.append((metrics, model.state_dict()))
    for k in out[0][0]:
        assert float(out[0][0][k]) == float(out[1][0][k]), k
    for k in out[0][1]:
        torch.testing.assert_close(out[0][1][k], out[1][1][k], rtol=0, atol=0)


def test_trainer_refuses_what_later_slices_port(tmp_path, monkeypatch):
    """No knob of the JAX trainer is left for a later slice: ``hang_s``
    arms the watchdog, which is stopped when ``train`` returns, and
    ``--max_restarts`` parses without ``--supervise`` (unused then, as in
    the JAX CLI). Without a card the trainer raises before it writes
    anything."""
    from raft_tpu_torch.cli.train import build_parser

    cfg = RAFTConfig(small=True)
    loader = Loader()
    ran = tmp_path / "ran"
    state = train(cfg, TrainConfig(num_steps=1, validation=(), hang_s=60.0,
                                   checkpoint_dir=str(ran),
                                   log_dir=str(ran)),
                  loader=loader, device="cpu")
    assert state.step == 1
    assert not [t for t in threading.enumerate()
                if t.name.startswith("HangWatch") and t.is_alive()]
    args = build_parser().parse_args(["--max_restarts", "3"])
    assert not args.supervise and args.max_restarts == 3
    refused = tmp_path / "refused"
    refused.mkdir()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, TrainConfig(num_steps=1, validation=(),
                               checkpoint_dir=str(refused),
                               log_dir=str(refused)), loader=loader)
    assert not os.listdir(refused)
