"""Full-state checkpoints, resume and the curriculum's restart rules of the
port, on the CPU (``training.checkpoint``, ``training.trainer``,
``utils.ckpt_scan``, ``tools.convert``'s manifest).

- A full-state save restores bitwise: parameters, batch-norm buffers,
  AdamW's moments and steps, the OneCycle scheduler, the step and torch's
  default generator.
- A run saved at step k and resumed reaches bitwise the weights at step N
  of an uninterrupted run fed the same batches, with image noise and
  dropout drawn per (seed, step): the port's own uninterrupted run is the
  reference (CPU convs are deterministic).
- A torn or corrupt newest step is quarantined (renamed ``.corrupt``) and
  the previous one restored; a named damaged step raises and stays.
- ``train_curriculum`` quarantines a corrupt stage final and retrains the
  stage, and a second run skips every intact stage.
- ``save_pth`` writes atomically with a sha256 manifest in the JAX
  package's format, which ``raft_tpu.tools.convert.verify_manifest`` reads.
"""

import copy
import os

import numpy as np
import pytest
import torch

from raft_tpu.tools.convert import verify_manifest as jax_verify_manifest
from raft_tpu_torch.config import RAFTConfig, stage_config
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.tools.convert import (CorruptCheckpointError, load_pth,
                                          manifest_path, save_pth)
from raft_tpu_torch.training import checkpoint as ckpt
from raft_tpu_torch.training.train_step import (create_train_state,
                                                make_train_step)
from raft_tpu_torch.training.trainer import train, train_curriculum
from raft_tpu_torch.utils.ckpt_scan import step_dirs

CFG = RAFTConfig(small=True, dropout=0.1)
HW = (32, 48)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        im1 = rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8)
        out.append({"image1": im1, "image2": np.roll(im1, 2, axis=2),
                    "flow": (2 * rng.randn(2, *HW, 2)).astype(np.float32),
                    "valid": (rng.rand(2, *HW) > 0.1).astype(np.uint8)})
    return out


def _tc(tmp, **kw):
    base = dict(name="ck", batch_size=2, image_size=HW, iters=2, num_steps=3,
                val_freq=2, sum_freq=1, add_noise=True, validation=(),
                checkpoint_dir=str(tmp / "ckpt"), log_dir=str(tmp / "runs"))
    base.update(kw)
    return stage_config("chairs", **base)


def _stepped_state(tc, steps=2):
    state = create_train_state(RAFT(CFG), tc)
    step = make_train_step(CFG, tc)
    for batch in _batches(steps):
        step(state, batch)
    return state


def _flat(tree, prefix=""):
    """Every leaf of a nested state dict, by path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        return _flat(dict(enumerate(tree)), prefix)
    return {prefix: tree}


def _assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_full_state_round_trip_is_bitwise(tmp_path):
    tc = _tc(tmp_path)
    state = _stepped_state(tc)
    torch.rand(3)                       # move the default generator
    path = ckpt.save_train_state(str(tmp_path / "steps"), state)
    assert os.path.basename(path) == "2"
    saved = ckpt._as_tree(state)
    fresh = create_train_state(RAFT(CFG, torch.Generator().manual_seed(9)),
                               tc)
    torch.manual_seed(5)
    ckpt.restore_train_state(str(tmp_path / "steps"), fresh)
    assert fresh.step == 2 == ckpt.latest_step(str(tmp_path / "steps"))
    _assert_same(ckpt._as_tree(fresh), saved)
    assert fresh.scheduler.get_last_lr() == state.scheduler.get_last_lr()
    assert len(fresh.optimizer.state) == len(list(state.model.parameters()))


class Crash(RuntimeError):
    pass


class CrashingLoader:
    """Yields ``batches`` and then, if ``crash``, raises: a run killed in
    the middle of its stage."""

    def __init__(self, batches, crash=False):
        self.batches, self.crash = batches, crash

    def __iter__(self):
        yield from self.batches
        if self.crash:
            raise Crash("preempted")


def test_resume_reaches_the_uninterrupted_weights(tmp_path):
    batches = _batches(3, seed=1)
    full = train(CFG, _tc(tmp_path / "a"), loader=batches, device="cpu")
    tc = _tc(tmp_path / "b")
    # the trainer runs two batches ahead: the crash comes after step 1 of
    # 3 (saved, as val_freq=2 saves at state.step 1) and before step 2
    with pytest.raises(Crash):
        train(CFG, tc, loader=CrashingLoader(batches[:2], crash=True),
              device="cpu")
    stage_dir = os.path.join(tc.checkpoint_dir, tc.name, tc.stage)
    assert [s for s, _ in step_dirs(stage_dir)] == [1]
    resumed = train(CFG, tc, resume=True, loader=batches[1:], device="cpu")
    assert resumed.step == full.step == 3
    assert resumed.scheduler.get_last_lr() == full.scheduler.get_last_lr()
    for (k, a), b in zip(full.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    final = load_pth(os.path.join(tc.checkpoint_dir, "ck.pth"), CFG)
    for k, v in final.state_dict().items():
        assert torch.equal(v, full.model.state_dict()[k]), k


def _two_steps(tmp_path):
    tc = _tc(tmp_path)
    state = _stepped_state(tc, steps=1)
    d = str(tmp_path / "steps")
    ckpt.save_train_state(d, state)
    saved = copy.deepcopy(ckpt._as_tree(state))
    make_train_step(CFG, tc)(state, _batches(1, seed=3)[0])
    ckpt.save_train_state(d, state)
    return tc, d, saved


@pytest.mark.parametrize("damage", ["truncate", "flip", "no_manifest"])
def test_damaged_newest_step_is_quarantined(tmp_path, damage, capsys):
    tc, d, saved = _two_steps(tmp_path)
    victim = os.path.join(d, "2", "state.pt")
    data = open(victim, "rb").read()
    if damage == "truncate":
        open(victim, "wb").write(data[:len(data) // 2])
    elif damage == "flip":
        open(victim, "wb").write(data[:100] + bytes([data[100] ^ 1])
                                 + data[101:])
    else:
        os.unlink(manifest_path(victim))
    fresh = create_train_state(RAFT(CFG), tc)
    ckpt.restore_train_state(d, fresh)
    assert fresh.step == 1
    _assert_same(ckpt._as_tree(fresh)["model"], saved["model"])
    assert os.path.isdir(os.path.join(d, "2.corrupt"))
    assert [s for s, _ in step_dirs(d)] == [1]
    assert "quarantined" in capsys.readouterr().out


def test_named_damaged_step_raises_and_stays(tmp_path):
    tc, d, _ = _two_steps(tmp_path)
    victim = os.path.join(d, "2", "state.pt")
    data = open(victim, "rb").read()
    open(victim, "wb").write(data[:-1] + bytes([data[-1] ^ 1]))
    fresh = create_train_state(RAFT(CFG), tc)
    with pytest.raises(ckpt.StepDamagedError, match="integrity"):
        ckpt.restore_train_state(d, fresh, step=2)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_train_state(d, fresh, step=7)
    assert [s for s, _ in step_dirs(d)] == [2, 1]
    assert fresh.step == 0


def test_save_pth_manifest_is_the_jax_format(tmp_path):
    model = RAFT(RAFTConfig(small=True))
    path = str(tmp_path / "w.pth")
    save_pth(model, path)
    data = open(path, "rb").read()
    jax_verify_manifest(path, data)         # the JAX package reads it
    assert not [f for f in os.listdir(tmp_path) if "tmp" in f]
    open(path, "wb").write(data[:-8])
    with pytest.raises(CorruptCheckpointError):
        load_pth(path, RAFTConfig(small=True))


def test_curriculum_quarantines_a_corrupt_final_and_skips_intact_stages(
        tmp_path):
    cfg = RAFTConfig(small=True)
    calls = []

    def loader_factory(tc):
        calls.append(tc.stage)
        return _batches(1)

    kw = dict(num_steps=1, batch_size=2, image_size=HW, iters=1,
              validation=(), checkpoint_dir=str(tmp_path / "ckpt"),
              log_dir=str(tmp_path / "runs"))
    stages = ["chairs", "things"]
    train_curriculum(stages, cfg, name="cur", loader_factory=loader_factory,
                     device="cpu", **kw)
    assert calls == stages
    finals = [str(tmp_path / "ckpt" / f"cur-{s}.pth") for s in stages]
    assert all(os.path.exists(f) for f in finals)
    # a second run repeats nothing
    train_curriculum(stages, cfg, name="cur", loader_factory=loader_factory,
                     device="cpu", **kw)
    assert calls == stages
    # bit rot in the first stage's final: quarantined and retrained
    data = open(finals[0], "rb").read()
    open(finals[0], "wb").write(data[:-1] + bytes([data[-1] ^ 1]))
    train_curriculum(stages, cfg, name="cur", loader_factory=loader_factory,
                     device="cpu", **kw)
    assert calls == stages + ["chairs"]
    assert os.path.exists(finals[0] + ".corrupt")
    assert os.path.exists(manifest_path(finals[0] + ".corrupt"))
    load_pth(finals[0], cfg)
