"""The training entry points of the port end to end on the CPU, at a tiny
size: ``cli/train.main --device cpu --synthetic ...`` (the real decode,
augmentation, collate and loader behind it), then ``--resume`` to more
steps; ``cli/curriculum.main`` over two stages whose datasets are written
in their on-disk layouts; and ``profile_steps`` writing a trace.

- ``--synthetic 4`` writes 4 FlyingChairs-shaped 384x512 samples with the
  port's PPM and ``.flo`` writers, trains 3 steps (a full-state save, the
  weights as ``2_<name>.pth`` and a KITTI validation at step 1, with the
  validation's metrics in ``metrics.jsonl``), and the final ``.pth`` loads
  with ``strict=True`` into both packages.
- ``--resume --num_steps 5`` continues from the newest full state: the
  step count and the learning rate go on from it.
- The curriculum trains chairs then kitti, each stage's final chained into
  the next, and a second run skips both. Its KITTI frames are one pixel
  larger than the kitti crop (288x960) each way: ``SparseFlowAugmentor``
  skips its resize on a fifth of its draws, and a frame smaller than the
  crop then raises, as the JAX package's does (pinned below).
"""

import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.data.augmentor import SparseFlowAugmentor as JaxSparseAugmentor
from raft_tpu.tools.convert import load_pth as jax_load_pth
from raft_tpu_torch.cli import curriculum
from raft_tpu_torch.cli import train as train_cli
from raft_tpu_torch.config import RAFTConfig, stage_config
from raft_tpu_torch.data import frame_utils as fu
from raft_tpu_torch.data.augmentor import SparseFlowAugmentor
from raft_tpu_torch.data.png import write_png
from raft_tpu_torch.tools.convert import load_pth
from raft_tpu_torch.training.trainer import train


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


KITTI_CROP = (288, 960)         # the kitti stage's crop (config.py)


def write_kitti(root, n=2, hw=(KITTI_CROP[0] + 1, KITTI_CROP[1] + 1)):
    """``n`` KITTI-layout pairs of ``hw`` frames; the default is one pixel
    over the kitti crop each way, the least a kitti stage can train on."""
    rng = np.random.RandomState(7)
    d = osp.join(root, "KITTI", "training")
    os.makedirs(osp.join(d, "image_2"))
    os.makedirs(osp.join(d, "flow_occ"))
    for i in range(n):
        for s in ("10", "11"):
            write_png(osp.join(d, "image_2", f"{i:06d}_{s}.png"),
                      rng.randint(0, 256, (*hw, 3)).astype(np.uint8))
        px = np.concatenate([64 * 3 * rng.randn(*hw, 2) + 2 ** 15,
                             rng.rand(*hw, 1) > 0.3], -1).astype(np.uint16)
        write_png(osp.join(d, "flow_occ", f"{i:06d}_10.png"), px)


def _records(path):
    return [json.loads(line) for line in open(path)]


def test_cli_train_synthetic_then_resume(tmp_path):
    # validation only (never cropped): small frames keep it quick
    write_kitti(str(tmp_path / "data"), hw=(64, 160))
    argv = ["--device", "cpu", "--small", "--name", "cli", "--synthetic", "4",
            "--batch_size", "2", "--image_size", "64", "96", "--iters", "2",
            "--num_workers", "2", "--val_freq", "2", "--validation", "kitti",
            "--data_root", str(tmp_path / "data"),
            "--checkpoint_dir", str(tmp_path / "ckpt"),
            "--log_dir", str(tmp_path / "runs")]
    state = train_cli.main(argv + ["--num_steps", "3"])
    assert state.step == 3
    ckpt = tmp_path / "ckpt"
    assert len([f for f in os.listdir(ckpt / "synthetic_chairs_4")
                if f.endswith(".ppm")]) == 8
    assert sorted(os.listdir(ckpt / "cli" / "chairs")) == ["1", "3"]
    assert (ckpt / "2_cli.pth").exists() and (ckpt / "cli.pth").exists()
    records = _records(tmp_path / "runs" / "cli" / "metrics.jsonl")
    assert any("kitti-epe" in r and "kitti-f1" in r for r in records)
    assert any(r.get("train_loop_steps") == 3 for r in records)
    load_pth(str(ckpt / "cli.pth"), RAFTConfig(small=True))   # strict=True
    jax_load_pth(str(ckpt / "cli.pth"), JaxConfig(small=True))

    lr = state.scheduler.get_last_lr()[0]
    resumed = train_cli.main(argv + ["--num_steps", "5", "--resume"])
    assert resumed.step == 5
    assert resumed.scheduler.last_epoch == 5
    assert resumed.scheduler.get_last_lr()[0] != lr
    records = _records(tmp_path / "runs" / "cli" / "metrics.jsonl")
    assert records[-1]["train_loop_steps"] == 2       # steps 3 and 4 only


def test_profile_steps_writes_a_trace(tmp_path):
    batches = []
    rng = np.random.RandomState(0)
    for _ in range(3):
        im = rng.randint(0, 256, (1, 32, 32, 3)).astype(np.uint8)
        batches.append({"image1": im, "image2": im,
                        "flow": np.zeros((1, 32, 32, 2), np.float32),
                        "valid": np.ones((1, 32, 32), np.uint8)})
    tc = stage_config("chairs", name="prof", batch_size=1,
                      image_size=(32, 32), iters=1, num_steps=3,
                      validation=(), profile_steps=(1, 2),
                      checkpoint_dir=str(tmp_path / "ckpt"),
                      log_dir=str(tmp_path / "runs"))
    train(RAFTConfig(small=True), tc, loader=batches, device="cpu")
    traces = os.listdir(tmp_path / "runs" / "prof")
    assert any(t.endswith(".pt.trace.json") for t in traces), traces


def write_chairs(root, n=2, hw=(384, 512)):
    rng = np.random.RandomState(8)
    d = osp.join(root, "FlyingChairs_release", "data")
    os.makedirs(d)
    train_cli.make_synthetic_chairs(d, n, hw)
    np.savetxt(osp.join(d, "chairs_split.txt"), [1] * n, fmt="%d")
    # a smooth flow, so the chairs samples are not all noise
    for i in range(n):
        fu.write_flow(osp.join(d, f"{i:05d}_flow.flo"),
                      np.full((*hw, 2), rng.randn(), np.float32))


@pytest.mark.parametrize("augmentor", [SparseFlowAugmentor,
                                       JaxSparseAugmentor])
def test_sparse_sample_smaller_than_the_crop_raises_without_resize(augmentor):
    """With its resize skipped (``spatial_aug_prob`` 0), the sparse
    augmentor crops the frame as it is: one smaller than the crop raises in
    the crop's ``randint``, in both packages; one a pixel larger fits."""
    aug = augmentor(KITTI_CROP, rng=np.random.RandomState(0))
    aug.spatial_aug_prob = 0.0
    rng = np.random.RandomState(1)

    def sample(hw):
        return (rng.randint(0, 256, (*hw, 3)).astype(np.uint8),
                rng.randint(0, 256, (*hw, 3)).astype(np.uint8),
                rng.randn(*hw, 2).astype(np.float32),
                (rng.rand(*hw) > 0.3).astype(np.float32))

    with pytest.raises(ValueError):
        aug.spatial_transform(*sample((64, 160)))
    out = aug.spatial_transform(*sample((KITTI_CROP[0] + 1,
                                         KITTI_CROP[1] + 1)))
    assert out[0].shape == (*KITTI_CROP, 3)


def test_cli_curriculum_two_stages(tmp_path, capsys, monkeypatch):
    # the curriculum CLI has no --log_dir: the stages log under ./runs
    monkeypatch.chdir(tmp_path)
    data = str(tmp_path / "data")
    write_chairs(data)
    write_kitti(data)
    argv = ["--device", "cpu", "--small", "--name", "cur",
            "--stages", "chairs", "kitti", "--num_steps", "1",
            "--batch_size", "1", "--data_root", data,
            "--checkpoint_dir", str(tmp_path / "ckpt")]
    curriculum.main(argv)
    finals = [tmp_path / "ckpt" / f"cur-{s}.pth" for s in ("chairs", "kitti")]
    assert all(f.exists() for f in finals)
    chairs, kitti = (load_pth(str(f), RAFTConfig(small=True)).state_dict()
                     for f in finals)
    assert any(not torch.equal(chairs[k], kitti[k]) for k in chairs)
    curriculum.main(argv)
    out = capsys.readouterr().out
    assert out.count("skipping") == 2
