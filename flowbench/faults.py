"""Faults planted under the timed path, to show that ``correct`` catches
them: each patches the system under test for the length of a ``with``
block (the CPU tests use them, and ``flowbench.calibrate`` reads their
numbers on the card).

- ``serve.altered``: every served flow shifted by half a pixel where the
  engine hands it back;
- ``serve.unchanged``: every dispatch hands back the last dispatch's flows
  of its batch size (an answer that never moves on);
- ``train.unchanged``: a step that leaves the parameters as they were;
- ``train.half``: half of each batch left out, the mean over the rest;
- ``train.altered``: the loss scaled by 1.5 where it is produced.
"""

from __future__ import annotations

import contextlib

import numpy as np

KINDS = ("serve.altered", "serve.unchanged", "train.unchanged", "train.half",
         "train.altered")


@contextlib.contextmanager
def planted(kind: str):
    import raft_tpu_torch.serving.engine as engine_mod
    import raft_tpu_torch.training.train_step as step_mod

    if kind not in KINDS:
        raise ValueError(f"fault {kind!r}: choose one of {KINDS}")
    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    if kind.startswith("serve."):
        fetch = engine_mod.PendingBatch.fetch
        last = {}

        def broken_fetch(self):
            out = fetch(self)
            if kind == "serve.altered":
                return out + np.float32(0.5)
            stale = last.get(len(out), out)
            last[len(out)] = out
            return stale

        patch(engine_mod.PendingBatch, "fetch", broken_fetch)
    elif kind == "train.altered":
        loss = step_mod.sequence_loss_subpixel

        def scaled(*args, **kw):
            value, metrics = loss(*args, **kw)
            return 1.5 * value, metrics

        patch(step_mod, "sequence_loss_subpixel", scaled)
    else:
        make = step_mod.make_train_step

        def broken_make(*args, **kw):
            step = make(*args, **kw)

            def broken(state, batch):
                if kind == "train.half":
                    batch = {k: v[:len(v) // 2] for k, v in batch.items()}
                    return step(state, batch)
                keep = {k: v.detach().clone()
                        for k, v in state.model.state_dict().items()}
                out = step(state, batch)
                state.model.load_state_dict(keep)
                return out
            return broken

        patch(step_mod, "make_train_step", broken_make)
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)
