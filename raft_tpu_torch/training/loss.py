"""Sequence loss over the iterations' flow predictions (train.py:47-72),
port of ``raft_tpu/training/loss.py``.

In a step over a mesh (``group``: every rank of it) each rank holds an
equal share of the batch's elements, its rows of the ``data`` axis and
its band of the ``spatial`` axis: the loss, each iteration's mean over
all of its elements, is the mean of the ranks' losses (the step averages
it and the gradients), while the metrics, means over the VALID pixels
only, are summed as (sum, count) across the ranks, not averaged as
means."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from raft_tpu_torch.config import MAX_FLOW
from raft_tpu_torch.ops.flow_ops import standard_to_subpixel


def _gamma_weighted_masked_l1(flow_preds, gt, vmask, gamma):
    """sum_i gamma^(T-1-i) * mean(vmask * |pred_i - gt|); the mean runs over
    ALL elements, not just the valid ones, as train.py:58-60 does."""
    T = flow_preds.shape[0]
    i = torch.arange(T, dtype=torch.float32, device=flow_preds.device)
    weights = gamma ** (T - 1 - i)
    l1 = (flow_preds - gt[None]).abs()
    per_iter = (vmask * l1).mean(dim=tuple(range(1, l1.dim())))
    return (weights * per_iter).sum()


def _final_pred_metrics(epe, valid, group=None) -> Dict[str, torch.Tensor]:
    """epe/1px/3px/5px over the valid pixels of the final prediction
    (train.py:62-70). ``epe`` and ``valid`` share one shape. With a
    ``group``, over the valid pixels of every rank's rows."""
    vf = valid.float()
    if group is not None:
        import torch.distributed as dist

        with torch.no_grad():
            sums = torch.stack([(x * vf).sum() for x in (
                epe, (epe < 1).float(), (epe < 3).float(),
                (epe < 5).float(), torch.ones_like(vf))])
            dist.all_reduce(sums, group=group)
        count = sums[4].clamp(min=1.0)
        return dict(zip(("epe", "1px", "3px", "5px"), sums[:4] / count))
    count = vf.sum().clamp(min=1.0)

    def vmean(x):
        return (x * vf).sum() / count

    return {"epe": vmean(epe), "1px": vmean((epe < 1).float()),
            "3px": vmean((epe < 3).float()), "5px": vmean((epe < 5).float())}


def sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor,
                  valid: torch.Tensor, gamma: float = 0.8,
                  max_flow: float = MAX_FLOW, group=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """γ-weighted L1 over all iteration outputs. flow_preds (T, B, H, W, 2),
    flow_gt (B, H, W, 2), valid (B, H, W). A pixel counts when
    ``valid >= 0.5`` and ``|gt| < max_flow`` (train.py:53-55)."""
    mag = flow_gt.pow(2).sum(-1).sqrt()
    valid = (valid >= 0.5) & (mag < max_flow)
    vmask = valid[None, ..., None].float()
    flow_loss = _gamma_weighted_masked_l1(flow_preds, flow_gt, vmask, gamma)
    epe = (flow_preds[-1] - flow_gt).pow(2).sum(-1).sqrt()
    return flow_loss, _final_pred_metrics(epe, valid, group)


def sequence_loss_subpixel(up_raw: torch.Tensor, flow_gt: torch.Tensor,
                           valid: torch.Tensor, gamma: float = 0.8,
                           max_flow: float = MAX_FLOW, group=None
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`sequence_loss` in the upsampler's subpixel domain: up_raw
    (T, B, 2, 64, H*W) from ``convex_upsample_batched_raw``; flow_gt
    (B, 8H, 8W, 2) and valid (B, 8H, 8W) are moved once into the same
    layout. Every reduction runs over whole element sets, so the values are
    those of the standard loss, without the (T, B, 8H, 8W, 2) stack."""
    gt_t = standard_to_subpixel(flow_gt)                     # (B, 2, 64, HW)
    valid_t = standard_to_subpixel(valid[..., None])[:, 0]   # (B, 64, HW)
    mag = gt_t.pow(2).sum(1).sqrt()
    valid_t = (valid_t >= 0.5) & (mag < max_flow)
    vmask = valid_t[None, :, None].float()                   # (1,B,1,64,HW)
    flow_loss = _gamma_weighted_masked_l1(up_raw, gt_t, vmask, gamma)
    epe = (up_raw[-1] - gt_t).pow(2).sum(1).sqrt()
    return flow_loss, _final_pred_metrics(epe, valid_t, group)
