"""The training cell: the port's train step (``make_train_step``) over a pool
of batches made on the device from the seed, the window timed by the host
clock, and its first three steps held against the reference's.

A traffic mix of kind ``train`` names the stage's recipe (``batch``,
``image_size``, ``iters``, ``lr``, ``wdecay``, ``epsilon``, ``clip``,
``gamma``, ``num_steps``), the pool (``batches`` distinct batches, flows
up to about ``max_flow`` px). A traced run profiles :data:`TRACE_STEPS`
steps.

Set-up builds one train state and drives it through its first three
steps, each on its own batch, by the call the window makes: those steps
compile and warm every kernel, and their loss, the first step's clipped
gradient (as AdamW holds it: ``exp_avg`` / (1 − β1) after one step) and
each parameter's change over the three are what the reference is held to.
The window then steps the same state on.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from flowbench import check, counts, frames, trace
from flowbench.reference import raft as ref_raft
from flowbench.reference import train as ref_train
from flowbench.weights import make_weights

#: the steps set-up takes, which the reference repeats
FIRST = 3
#: the steps a traced run profiles
TRACE_STEPS = 8


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def run(cell, seed: int, seconds: int, traced: bool, device,
        t_process: float, stages: Dict) -> Dict:
    """One training run; see :mod:`flowbench.kinds` for what it returns."""
    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.training.train_step import (create_train_state,
                                                    make_train_step)

    stages["import_port"] = time.perf_counter() - t_process
    cfg, tr = cell.config, cell.traffic
    arch, prog, tcfg = cfg["architecture"], cfg["program"], cfg["train"]
    check.set_precision(tcfg["precision"])
    weights = make_weights(arch, seed, device)
    stages["weights"] = time.perf_counter() - t_process
    batches = frames.train_batches(tr["batches"], tr["batch"],
                                   tuple(tr["image_size"]), tr["max_flow"],
                                   seed, device)
    stages["inputs"] = time.perf_counter() - t_process
    model_cfg = RAFTConfig(small=arch["small"],
                           mixed_precision=tcfg["mixed_precision"], **prog)
    train_cfg = TrainConfig(
        stage="chairs", lr=tr["lr"], num_steps=tr["num_steps"],
        batch_size=tr["batch"], image_size=tuple(tr["image_size"]),
        wdecay=tr["wdecay"], epsilon=tr["epsilon"], clip=tr["clip"],
        gamma=tr["gamma"], iters=tr["iters"], validation=())
    model = RAFT(model_cfg)
    model.load_state_dict(weights)
    state = create_train_state(model.to(device), train_cfg)
    step = make_train_step(model_cfg, train_cfg)
    stages["state"] = time.perf_counter() - t_process
    named = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in named.items()}
    losses = []
    for i in range(FIRST):
        losses.append(step(state, batches[i % len(batches)])["loss"])
        if i == 0:
            beta1 = state.optimizer.param_groups[0]["betas"][0]
            grad = norms({k: state.optimizer.state[p]["exp_avg"] / (1 - beta1)
                          for k, p in named.items()})
    first = {"loss": [float(x) for x in losses], "grad": grad,
             "change": norms({k: p.detach() - start[k]
                              for k, p in named.items()})}
    del start
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_process

    done = FIRST
    with trace.Slice(device, traced) as sl:
        t0 = time.perf_counter()
        if traced:
            for _ in range(TRACE_STEPS):
                step(state, batches[done % len(batches)])
                done += 1
        else:
            while time.perf_counter() - t0 < seconds:
                step(state, batches[done % len(batches)])
                done += 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
    steps = done - FIRST
    stages["window"] = time.perf_counter() - t_process
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    out = {"setup_s": setup_s, "attempted": steps, "failed": 0,
           "peak_bytes": peak, "notes": {"window_s": t1 - t0,
                                         "steps": steps}}
    if not traced:
        out["e2e"] = {"train_pairs_per_s": steps * tr["batch"] / (t1 - t0)}
    else:
        hw = tuple(tr["image_size"])
        hw8 = (hw[0] // 8, hw[1] // 8)
        n = steps * tr["iters"]
        L, r = arch["corr_levels"], arch["corr_radius"]
        out["ctx"] = {
            "events": sl.events, "window_s": sl.window_s,
            "busy_s": trace.union_s(sl.events),
            "pairs": steps * tr["batch"],
            "flops_per_pair": counts.train_flops(arch, hw, tr["iters"]),
            "peak_flops": counts.PEAKS[tcfg["peak"]],
            "launch_bounds": {
                "k1": [(n, trace.kernel_bound(counts.lookup_cost(
                    tr["batch"], hw8, L, r)))],
                "k3": [(n, trace.kernel_bound(counts.scatter_kernel_cost(
                    tr["batch"], hw8, L, r)))]},
        }
    del state, model, step, named
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.train_numbers(first, reference_first(cell, weights,
                                                         batches, device))
    stages["reference"] = time.perf_counter() - t_process
    out["checks"] = check.judged(numbers, check.limits(cell.name, cell.root))
    return out


def reference_first(cell, weights, batches: List[Dict], device,
                    quantize=None) -> Dict:
    """The reference's first three steps from the same weights on the
    same batches: their losses, the first step's clipped gradient's leaf
    norms and each leaf's change over the three. ``quantize`` rounds its
    convolutions' operands to a lower precision (the control)."""
    tr = cell.traffic
    with check.reference_precision():
        model = ref_raft.RAFT(cell.config["architecture"], quantize).to(device)
        model.load_state_dict(weights)
        opt, sched = ref_train.make_optimizer(model, tr)
        start = {k: p.detach().clone() for k, p in model.named_parameters()}
        losses, grad = [], None
        for i in range(FIRST):
            out = ref_train.train_step(model, opt, sched,
                                       batches[i % len(batches)], tr)
            losses.append(out["loss"])
            if i == 0:
                grad = norms(out["grads"])
            del out
        change = norms({k: p.detach() - start[k]
                        for k, p in model.named_parameters()})
        del model, opt, start
    return {"loss": losses, "grad": grad, "change": change}
