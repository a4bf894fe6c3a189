"""Test-mode forward, port of ``raft_tpu/evaluation/evaluate.py``
(``make_forward`` only; the validators are ROADMAP M7)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.config import RAFTConfig


def resolve_device(device: Optional[str] = "cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises when CUDA is asked for and there is none — an entry
    point never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: raft_tpu_torch runs on the GPU unless asked for "
            "the CPU (pass device='cpu', or --device cpu on the command line)")
    return dev


def make_forward(config: RAFTConfig, iters: int, device: str = "cuda"):
    """Test-mode forward on ``device``: ``fwd(model, image1, image2)`` and
    ``fwd_init(model, image1, image2, flow_init)`` return ``(flow_low,
    flow_up)``. ``model`` is a ``RAFT`` built for ``config``; each call
    moves it to the device in place (a no-op once it is there). Images are
    (B, H, W, 3) numpy arrays or tensors with H, W % 8 == 0."""
    dev = resolve_device(device)

    def _prep(model):
        if model.config != config:
            raise ValueError("model was built for another RAFTConfig")
        return model.to(dev).eval()

    def _as_tensor(a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(dev, torch.float32)

    @torch.no_grad()
    def fwd(model, image1, image2):
        return _prep(model)(_as_tensor(image1), _as_tensor(image2),
                            iters=iters, test_mode=True)

    @torch.no_grad()
    def fwd_init(model, image1, image2, flow_init):
        return _prep(model)(_as_tensor(image1), _as_tensor(image2),
                            iters=iters, flow_init=_as_tensor(flow_init),
                            test_mode=True)

    return fwd, fwd_init
