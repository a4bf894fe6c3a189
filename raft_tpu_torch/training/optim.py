"""AdamW + linear OneCycle + global-norm clip, port of
``raft_tpu/training/optim.py`` (the reference's ``fetch_optimizer``,
train.py:79-86, and its clip before the step, train.py:176-177)."""

from __future__ import annotations

from typing import Iterable, List

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   num_steps: int, wdecay: float = 1e-4,
                   epsilon: float = 1e-8):
    """(AdamW(β 0.9/0.999, ``epsilon``, ``wdecay``), its OneCycleLR over
    ``num_steps + 100`` steps, 5% linear warm-up, linear anneal)."""
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=epsilon,
                            weight_decay=wdecay)
    sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, max_lr=lr, total_steps=num_steps + 100, pct_start=0.05,
        anneal_strategy="linear", cycle_momentum=False)
    return opt, sched


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: each gradient becomes
    ``g / norm * max_norm`` when ``norm >= max_norm`` and stays as it is
    otherwise. (``torch.nn.utils.clip_grad_norm_`` divides by
    ``norm + 1e-6`` whatever the norm.) Returns the norm before the clip,
    on the device: nothing here waits for the card."""
    norm = global_norm(grads)
    keep = norm < max_norm
    one = torch.ones((), device=norm.device)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm
