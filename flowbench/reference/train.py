"""The published training step in plain PyTorch: the sequence loss, the
gradient clip, AdamW and the OneCycle schedule (princeton-vl/RAFT
``train.py``: ``sequence_loss``, ``fetch_optimizer`` and the step of
``train``), over :class:`flowbench.reference.raft.RAFT` in train mode.
Imports nothing but ``torch`` and the reference model."""

from __future__ import annotations

from typing import Dict, List

import torch

from flowbench.reference.raft import RAFT

MAX_FLOW = 400.0


def sequence_loss(preds: List[torch.Tensor], flow_gt: torch.Tensor,
                  valid: torch.Tensor, gamma: float) -> torch.Tensor:
    """γ-weighted L1 over every iteration's flow (B, 2, H, W); a pixel
    counts where ``valid >= 0.5`` and ``|gt| < 400``, and each mean runs
    over all elements, as published."""
    mag = torch.sum(flow_gt ** 2, dim=1).sqrt()
    valid = (valid >= 0.5) & (mag < MAX_FLOW)
    n = len(preds)
    loss = 0.0
    for i, pred in enumerate(preds):
        loss = loss + gamma ** (n - i - 1) * (
            valid[:, None] * (pred - flow_gt).abs()).mean()
    return loss


def make_optimizer(model: RAFT, recipe: Dict):
    """AdamW and its linear OneCycle schedule over ``num_steps + 100``
    steps with a 5% warm-up (``fetch_optimizer``)."""
    opt = torch.optim.AdamW(model.parameters(), lr=recipe["lr"],
                            weight_decay=recipe["wdecay"],
                            eps=recipe["epsilon"])
    sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, recipe["lr"], recipe["num_steps"] + 100, pct_start=0.05,
        cycle_momentum=False, anneal_strategy="linear")
    return opt, sched


def train_step(model: RAFT, opt, sched, batch: Dict[str, torch.Tensor],
               recipe: Dict) -> Dict[str, object]:
    """One step on ``batch`` (image1, image2 (B, H, W, 3) in [0, 255],
    flow (B, H, W, 2), valid (B, H, W)): returns the loss and each
    parameter's gradient after the clip, as AdamW receives it."""
    model.train()
    im1, im2, flow = (batch[k].permute(0, 3, 1, 2).float().contiguous()
                      for k in ("image1", "image2", "flow"))
    preds = model(im1, im2, recipe["iters"], test_mode=False)
    loss = sequence_loss(preds, flow, batch["valid"].float(),
                         recipe["gamma"])
    opt.zero_grad(set_to_none=False)
    loss.backward()
    for p in model.parameters():   # a leaf the loss never reaches steps on 0
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    torch.nn.utils.clip_grad_norm_(model.parameters(), recipe["clip"])
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    opt.step()
    sched.step()
    return {"loss": float(loss.detach()), "grads": grads}
