"""Portable model export through ``torch.export``, port of
``raft_tpu/serving/export.py`` (the ONNX-export analog).

``test_trt.py:102-161`` exports a single-output graph (``flowup``) with the
20-iteration loop baked in and dynamic batch/H/W axes. Here the serving
function is traced by ``torch.export.export`` into an ``ExportedProgram``
with the weights baked in, spatial dims static (the engine's buckets cover
the envelope) and the batch symbolic where ``dynamic_batch`` (the analog of
the StableHLO export's ``symbolic_shape("b")``), then saved to a ``.pt2``
file with ``torch.export.save``.

Traced through the kernel wrappers, the program holds the port's kernels
as ``torch.library`` operators (``raft_tpu_torch::corr_lookup``,
``::gru_gates``, ``::gru_blend``, ``::alt_corr_lookup``): a program traced
on the card launches them when it runs there, and one traced on the CPU
runs their plain versions. A process that loads a program imports
``raft_tpu_torch.kernels`` first (:func:`load_program` does), which
registers them.

    python -m raft_tpu_torch.cli.export --model raft-small.pth --small \\
        --out raft-small.pt2 [--device cpu]

The serving engine's program store (``serving/aot.py``) exports each
bucket's program the same way (:func:`export_bucket`): one program per
engine kind (``serve``, ``serve_warm`` with ``flow_init``,
``serve_cached``, ``serve_ragged``), traced at the bucket's static
shapes on the engine's static input dict, in its wire dtype. A loaded
program's parameters and buffers are then bound to the engine's live
tensors (:func:`bind_program`), so a weight swap reaches its replays.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Tuple

import torch
from torch import nn

from raft_tpu_torch.config import ITERS_EXPORT, RAFTConfig
from raft_tpu_torch.models import RAFT


class ServingModule(nn.Module):
    """``(image1, image2) -> flow_up`` with the weights baked in: the
    fork's single-output export (test_trt.py:131 names only ``flowup``).
    Images are (B, H, W, 3) float in [0, 255], H, W multiples of 8."""

    def __init__(self, model: RAFT, iters: int = ITERS_EXPORT):
        super().__init__()
        self.model = model
        self.iters = iters

    def forward(self, image1: torch.Tensor,
                image2: torch.Tensor) -> torch.Tensor:
        _, flow_up = self.model(image1, image2, iters=self.iters,
                                test_mode=True)
        return flow_up


def make_serving_fn(model: RAFT, config: RAFTConfig = RAFTConfig(),
                    iters: int = ITERS_EXPORT) -> ServingModule:
    """The serving function over ``model`` (built for ``config``), in eval
    mode."""
    if model.config != config:
        raise ValueError("model was built for another RAFTConfig")
    return ServingModule(model, iters).eval()


def export_program(model: RAFT, config: RAFTConfig = RAFTConfig(),
                   iters: int = ITERS_EXPORT,
                   image_hw: Tuple[int, int] = (440, 1024),
                   dynamic_batch: bool = True
                   ) -> torch.export.ExportedProgram:
    """Trace the serving function of a copy of ``model`` on its device
    with ``torch.export.export``. ``image_hw`` (multiples of 8) is static;
    the batch is symbolic (1 to 1024) with ``dynamic_batch``, else 1."""
    h, w = image_hw
    if h % 8 or w % 8:
        raise ValueError(f"image_hw={image_hw}: multiples of 8")
    serve = make_serving_fn(copy.deepcopy(model), config, iters)
    serve.requires_grad_(False)
    device = next(model.parameters()).device
    # batch 2 in the example: a size-1 example would pin the dim to 1. Two
    # tensors: one tensor given twice would be traced as one input
    example = tuple(torch.zeros((2 if dynamic_batch else 1, h, w, 3),
                                device=device) for _ in range(2))
    dynamic = None
    if dynamic_batch:
        b = torch.export.Dim("b", min=1, max=1024)
        dynamic = ({0: b}, {0: b})
    return torch.export.export(serve, example, dynamic_shapes=dynamic)


def load_program(path: str):
    """A callable ``(image1, image2) -> flow_up`` from a ``.pt2`` that
    ``torch.export.save`` wrote; the kernels' operators are registered
    first."""
    import raft_tpu_torch.kernels  # noqa: F401  (registers the operators)

    return torch.export.load(path).module()


class BucketProgram(nn.Module):
    """One serving bucket's program as a module: ``forward(inputs)`` runs
    ``fn`` (the engine's forward of a kind) on the bucket's input dict.
    ``model`` is held as a submodule, so the state dict's keys are the
    model's under ``model.``."""

    def __init__(self, model: RAFT, fn):
        super().__init__()
        self.model = model
        self._fn = fn

    def forward(self, inputs):
        return self._fn(inputs)


def export_bucket(model: RAFT, fn, inputs) -> torch.export.ExportedProgram:
    """``torch.export.export`` of :class:`BucketProgram` at the static
    shapes and dtypes of ``inputs`` (the engine's static input dict, on
    its device)."""
    return torch.export.export(BucketProgram(model, fn), (inputs,))


def bind_program(program: torch.export.ExportedProgram, model: RAFT):
    """The callable of an exported bucket program whose parameters and
    buffers ARE ``model``'s tensors (assigned, not copied): the ``.pt2``
    carries its own copy of the weights, and an engine's in-place weight
    swap must reach the program it replays. The kernels' operators are
    registered first."""
    import raft_tpu_torch.kernels  # noqa: F401  (registers the operators)

    module = program.module()
    module.load_state_dict(
        {f"model.{k}": v for k, v in model.state_dict().items()},
        strict=True, assign=True)
    return module


def main(argv=None):
    from raft_tpu_torch.cli._args import add_corr_args, corr_overrides
    from raft_tpu_torch.evaluation.evaluate import resolve_device
    from raft_tpu_torch.tools.convert import load_weights

    p = argparse.ArgumentParser(
        description="Export RAFT's serving function with torch.export")
    p.add_argument("--model", required=True,
                   help="weights: a reference .pth or a flax .msgpack")
    p.add_argument("--out", required=True, help="output .pt2 path")
    p.add_argument("--small", action="store_true")
    p.add_argument("--iters", type=int, default=ITERS_EXPORT)
    p.add_argument("--height", type=int, default=440)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--static_batch", action="store_true")
    add_corr_args(p)
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = RAFTConfig(small=args.small, **corr_overrides(args))
    model = load_weights(args.model, cfg).to(dev)
    program = export_program(model, cfg, args.iters,
                             (args.height, args.width),
                             dynamic_batch=not args.static_batch)
    torch.export.save(program, args.out)
    size = os.path.getsize(args.out)
    print(f"exported {size} bytes -> {args.out}", flush=True)
    print(json.dumps({"out": args.out, "bytes": size,
                      "image_hw": [args.height, args.width],
                      "batch": 1 if args.static_batch else "dynamic",
                      "iters": args.iters, "device": str(dev)}), flush=True)


if __name__ == "__main__":
    main()
