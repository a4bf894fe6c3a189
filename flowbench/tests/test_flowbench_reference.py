"""The frozen reference against ``raft_tpu_torch`` on the CPU at a small
size, from the same seeded weights: the test-mode forward of both
configurations, and the first training steps (loss, clipped gradient,
parameter change) of the basic one. The test may import the port; the
reference may not (``test_flowbench_imports``)."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from flowbench import check, frames
from flowbench.reference import raft as ref_raft
from flowbench.reference import train as ref_train
from flowbench.spec import HERE
from flowbench.weights import make_weights
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.ops.padding import InputPadder
from raft_tpu_torch.training.train_step import (create_train_state,
                                                make_train_step)


def _config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def pair():
    """A 124x250 crop of two consecutive Sintel frames (padded to 128x256
    by both sides)."""
    fr = frames.sintel_frames()
    return (torch.from_numpy(fr[None, 3, 100:224, 300:550].copy()),
            torch.from_numpy(fr[None, 4, 100:224, 300:550].copy()))


@pytest.mark.parametrize("name", ["raft_basic", "raft_small"])
@pytest.mark.parametrize("iters", [1, 4])
def test_forward_matches_the_port(pair, name, iters):
    cfg = _config(name)
    arch = cfg["architecture"]
    weights = make_weights(arch, 2 ** 40 + 3, "cpu")
    port = RAFT(RAFTConfig(small=arch["small"], **cfg["program"]))
    port.load_state_dict(weights)
    model = ref_raft.RAFT(arch).eval()
    model.load_state_dict(weights)
    im1, im2 = pair
    want = ref_raft.infer(model, im1, im2, iters)
    padder = InputPadder(im1.shape)
    with torch.no_grad():
        _, up = port(*padder.pad(im1.float(), im2.float()), iters=iters)
    got = padder.unpad(up)
    assert got.shape == want.shape == (1, 124, 250, 2)
    # one step agrees to float32 rounding; four amplify it a little
    tol = 1e-4 if iters == 1 else 1e-3
    assert check.epe(got[0].numpy(), want[0].numpy()) < tol
    assert float(want.abs().max()) > 0.1


def test_published_init():
    """Encoder kernels Kaiming-normal (fan-out), the rest PyTorch's
    default, norms at 1 and 0; the same seed draws the same weights."""
    arch = _config("raft_basic")["architecture"]
    w = make_weights(arch, 9, "cpu")
    k = w["fnet.layer1.0.conv1.weight"]             # 64 -> 64, 3x3
    assert float(k.std()) == pytest.approx((2 / (64 * 9)) ** 0.5, rel=0.05)
    u = w["update_block.gru.convz1.weight"]         # 384 -> 128, 1x5
    bound = 1 / (384 * 5) ** 0.5
    assert float(u.abs().max()) <= bound and float(u.abs().max()) > 0.9 * \
        bound
    assert torch.equal(w["cnet.norm1.weight"], torch.ones(64))
    assert torch.equal(w["cnet.layer2.0.norm3.weight"],
                       w["cnet.layer2.0.downsample.1.weight"])
    assert torch.equal(make_weights(arch, 9, "cpu")["fnet.conv1.weight"],
                       w["fnet.conv1.weight"])
    assert not torch.equal(make_weights(arch, 10, "cpu")["fnet.conv1.weight"],
                           w["fnet.conv1.weight"])


def test_train_steps_match_the_port():
    """Three steps of the chairs recipe in float32 from the same weights
    on the same batches: each step's loss, the first step's clipped
    gradient leaf by leaf, and each leaf's change."""
    cfg = _config("raft_basic")
    arch = cfg["architecture"]
    recipe = dict(batch=2, image_size=[128, 160], iters=2, lr=2.5e-4,
                  wdecay=1e-4, epsilon=1e-8, clip=1.0, gamma=0.8,
                  num_steps=120000)
    weights = make_weights(arch, 77, "cpu")
    batches = frames.train_batches(3, 2, (128, 160), 8.0, 77, "cpu")
    port = RAFT(RAFTConfig(small=False, **cfg["program"]))
    port.load_state_dict(weights)
    tc = TrainConfig(stage="chairs", lr=recipe["lr"], num_steps=120000,
                     batch_size=2, image_size=(128, 160), iters=2,
                     validation=())
    state = create_train_state(port, tc)
    step = make_train_step(port.config, tc)
    model = ref_raft.RAFT(arch)
    model.load_state_dict(weights)
    opt, sched = ref_train.make_optimizer(model, recipe)
    named = dict(port.named_parameters())
    assert named.keys() == dict(model.named_parameters()).keys()
    start = {k: p.detach().clone() for k, p in named.items()}
    start_ref = {k: p.detach().clone() for k, p in model.named_parameters()}
    prog, ref = {"loss": []}, {"loss": []}
    for i, batch in enumerate(batches):
        prog["loss"].append(float(step(state, batch)["loss"]))
        want = ref_train.train_step(model, opt, sched, batch, recipe)
        ref["loss"].append(want["loss"])
        if i == 0:
            prog["grad"] = {k: float(state.optimizer.state[p]["exp_avg"]
                                     .norm()) / 0.1
                            for k, p in named.items()}
            ref["grad"] = {k: float(g.norm())
                           for k, g in want["grads"].items()}
    prog["change"] = {k: float((p.detach() - start[k]).norm())
                      for k, p in named.items()}
    ref["change"] = {k: float((p.detach() - start_ref[k]).norm())
                     for k, p in model.named_parameters()}
    # leaves whose gradient is nought to rounding (the bias of a conv under
    # a norm) move by round-off alone; the comparison leaves them out
    med = float(np.median(list(ref["grad"].values())))
    out = {k for k, v in ref["grad"].items() if v < check.LEAF_FLOOR * med}
    assert out and all(k.endswith("bias") for k in out)
    numbers = check.train_numbers(prog, ref)
    assert numbers["loss_rel"] < 1e-5
    assert numbers["grad_leaf_rel"] < 1e-3, numbers
    # Adam's first steps move each element by about the learning rate,
    # whatever its gradient's size: a gradient element near zero flips its
    # step on a rounding, which the change's norm shows more than the
    # gradient's
    assert numbers["change_leaf_rel"] < 1e-2, numbers
