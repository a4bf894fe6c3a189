"""One train step, port of ``raft_tpu/training/train_step.py``.

The step runs the model in train mode (batch norms trained unless the
stage freezes them, ``freeze_bn = stage != "chairs"`` as train.py:147-148),
the sequence loss (fused into the upsampler's subpixel domain for the basic
model by default), the backward, the optax-form clip and AdamW with
OneCycle. The JAX step is a pure function of the state; here the state
holds the model, optimizer and scheduler, which the step updates in place.

Under ``mixed_precision`` the model computes in bf16 on the fp32
parameters (no loss scaling, as in JAX); the loss, the optimizer and the
parameters stay fp32. The step's random draws (image noise, then the
encoders' dropout masks) come from one generator seeded from (seed, step),
the analog of JAX's per-step key ``fold_in(rng, step)`` (train_step.py:107),
so a resumed run replays them.

Data parallel (``mesh=``, ``parallel.mesh``): each rank steps on its rows
of the global batch. It draws the global batch's noise and dropout masks
from the same generator and keeps its rows; the batch norms take the
global batch's statistics (``models.layers.BatchNorm2d``); after the
backward the gradients are summed over the ``data`` axis as one flat
buffer and divided by N, before the clip, so every rank clips and steps
identically; the loss and metrics are the global batch's. N ranks thus
compute what one rank computes on the whole batch (within the sums'
rounding). No ``DistributedDataParallel``: its ``module.`` prefix would
reach the saved weights and its bucketed overlap reorders the sums; a
one-device mesh runs no collective, bitwise the mesh-less step.

A ``spatial`` axis over 1 cuts the height as well: each rank's batch is
its rows of the ``data`` axis and its band of the ``spatial`` axis
(``parallel.mesh.shard_batch``), the model runs on the band
(``models.layers.set_spatial``: halo convs, norms over the band's group,
the query-sharded volume), the noise is the global image's, cut to the
band, and the sums above run over every rank of the mesh: each holds an
equal share of the elements, so the mean of the ranks' losses is the
global loss and one flat all-reduce of the gradients over the world,
divided by its size, is its gradient.

While a ``torch.profiler`` session runs, the step records its host phases
as layer spans (``serving/trace.py``): ``train.step`` around
``train.inputs``, ``train.forward``, ``train.loss``, ``train.backward``
and ``train.optimizer``, each launching a marker kernel on a CUDA device.
Unprofiled, each span site costs a flag read.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.models.layers import set_process_group, set_spatial
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.parallel.mesh import validate_spatial_extent
from raft_tpu_torch.serving.trace import span
from raft_tpu_torch.training.loss import sequence_loss, sequence_loss_subpixel
from raft_tpu_torch.training.optim import clip_by_global_norm_, make_optimizer

METRICS = ("loss", "epe", "1px", "3px", "5px", "grad_norm")


@dataclasses.dataclass
class TrainState:
    model: RAFT
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def _refuse_gma(model_cfg: RAFTConfig) -> None:
    if model_cfg.gma_heads:
        raise ValueError("training GMA (gma_heads=1) is not built: its "
                         "attention kernels (kernels.gma) have no backward")


def create_train_state(model: RAFT, train_cfg: TrainConfig) -> TrainState:
    """A fresh optimizer and schedule for ``model``, on its device."""
    _refuse_gma(model.config)
    opt, sched = make_optimizer(model.parameters(), train_cfg.lr,
                                train_cfg.num_steps, train_cfg.wdecay,
                                train_cfg.epsilon)
    return TrainState(model, opt, sched)


def _as_float(x, device) -> torch.Tensor:
    """A batch field (numpy or tensor, uint8 or float32) as float32 on
    ``device``; the uint8 wire format casts losslessly on the device."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device, non_blocking=True).float()


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``'s random draws (image noise, dropout),
    seeded from (seed, step), so a resumed run replays the stream. Its
    numbers are not JAX's. The seed is a hash of both: the CPU generator
    keeps only the low 32 bits of its seed, so ``(seed << 32) + step``
    would ignore ``seed`` there."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0]))
    return gen


def add_noise(image1, image2, gen: torch.Generator, draw_rows=None,
              band=None):
    """train.py:167-170: one stdv ~ U[0, 5) for the pair, then Gaussian
    noise of that stdv on each image, clipped to [0, 255].
    ``draw_rows=(start, global_batch)``: the images are rows ``start..``
    of a global batch, whose whole noise is drawn. ``band=(row0,
    global_h)``: the images are rows ``row0..`` of ``global_h``-high
    images (a ``spatial`` band), whose whole noise is drawn."""
    dev = image1.device
    b, h = image1.shape[:2]
    start, total = draw_rows if draw_rows is not None else (0, b)
    row0, height = band if band is not None else (0, h)
    stdv = 5.0 * torch.rand((), generator=gen, device=dev)
    return tuple((im + stdv * torch.randn(
        (total, height) + im.shape[2:], generator=gen,
        device=dev)[start:start + b, row0:row0 + h])
        .clamp(0.0, 255.0) for im in (image1, image2))


def all_reduce_mean_(grads, group, n: int) -> None:
    """The mean of ``grads`` over the ``n`` ranks of ``group``, in place,
    through one flat buffer (one collective, the same order of sums on
    every rank)."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= n
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_train_step(model_cfg: RAFTConfig, train_cfg: TrainConfig,
                    mesh=None):
    """``step(state, batch) -> metrics``: batch holds image1/image2
    (B,H,W,3) and valid (B,H,W), uint8 or float32, and flow (B,H,W,2)
    float32, on any device; metrics are the 0-dim tensors
    :data:`METRICS` on the model's device (nothing waits for the card).
    ``grad_norm`` is the global norm before the clip. With a ``mesh`` of
    more than one rank, ``batch`` is this rank's block of the global batch
    (``parallel.mesh.shard_batch``: rank ``i`` of the ``data`` axis holds
    rows ``i·B..``, rank ``s`` of the ``spatial`` axis band ``s`` of the
    height) and the metrics are the global batch's."""
    _refuse_gma(model_cfg)
    data = spatial = n = 1
    group = sp = None
    if mesh is not None:
        data, spatial = mesh.shape["data"], mesh.shape["spatial"]
        n, group, sp = mesh.size, mesh.world_group, mesh.spatial_context()
        if data > 1 and not model_cfg.split_encode:
            raise ValueError("a data axis over 1 needs split_encode "
                             "(parallel.partitioner.mesh_model_config)")
    freeze_bn = train_cfg.stage != "chairs"
    fused = (train_cfg.fused_loss is not False) and not model_cfg.small
    if train_cfg.fused_loss is True and model_cfg.small:
        warnings.warn(
            "fused_loss requested with the small model, which has no fused "
            "path (its upsampling is a plain 8x interpolate, not the learned "
            "convex mask the fusion rides on) — falling back to the "
            "standard sequence loss", stacklevel=2)
    loss_impl = sequence_loss_subpixel if fused else sequence_loss

    def train_step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        model = state.model
        if model.config != model_cfg:
            raise ValueError("the state's model was built for another "
                             "RAFTConfig")
        dev = next(model.parameters()).device
        with span("train.step", dev):
            with span("train.inputs", dev):
                image1 = _as_float(batch["image1"], dev)
                image2 = _as_float(batch["image2"], dev)
                valid = _as_float(batch["valid"], dev)
                flow = _as_float(batch["flow"], dev)
                gen = step_generator(train_cfg.seed, state.step, dev)
                rows = band = None
                b, h = image1.shape[:2]
                if data > 1:
                    rows = (mesh.coords[0] * b, data * b)
                if spatial > 1:
                    # before any collective: a band the fence refuses
                    # raises here
                    validate_spatial_extent(h * spatial, mesh)
                    band = (mesh.coords[1] * h, spatial * h)
                if train_cfg.add_noise:
                    image1, image2 = add_noise(image1, image2, gen, rows,
                                               band)
            with span("train.forward", dev):
                model.train()
                set_process_group(model, group)
                set_spatial(model, sp)
                preds = model(image1, image2, iters=train_cfg.iters,
                              test_mode=False, train=True,
                              freeze_bn=freeze_bn, raw_predictions=fused,
                              generator=gen, draw_rows=rows)
            with span("train.loss", dev):
                loss, metrics = loss_impl(preds, flow, valid,
                                          train_cfg.gamma, group=group)
            with span("train.backward", dev):
                state.optimizer.zero_grad()
                loss.backward()
                params = list(model.parameters())
                # optax updates every leaf; a missing grad is 0
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            with span("train.optimizer", dev):
                if group is not None:
                    all_reduce_mean_([p.grad for p in params], group, n)
                    loss = loss.detach().clone()
                    dist.all_reduce(loss, group=group)
                    loss /= n
                grad_norm = clip_by_global_norm_([p.grad for p in params],
                                                 train_cfg.clip)
                state.optimizer.step()
                state.scheduler.step()
            state.step += 1
            out = {k: v.detach() for k, v in metrics.items()}
            out.update(loss=loss.detach(), grad_norm=grad_norm)
        return out

    return train_step
