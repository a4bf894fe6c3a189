"""The port's training data pipeline against ``raft_tpu``'s.

Tiny datasets in each on-disk layout (FlyingChairs, FlyingThings3D, Sintel,
KITTI, HD1K), written with the port's PNG/PPM/``.flo``/``.pfm`` writers,
read by both packages:

- ``fetch_dataset`` per stage: the same sample count and the same members
  with the same ``n *`` multiplicities (the sintel stage's 100·sc + 100·sf
  + 200·k + 5·h + things); the first, a middle and the last sample of each
  mix, reseeded alike, within the augmentors' bounds
  (``tests/test_torch_augment.py``: images within 3 levels, flow 1e-4 px,
  sparse ``valid`` equal).
- ``PrefetchLoader`` at ``num_workers=1`` with the same seed: the same
  batches in the same order over two epochs, on the uint8 and the float32
  wire, within the same bounds.
- The uint8 wire: images and ``valid`` travel as uint8, flow as float32;
  fractional images or weights are refused.
- ``on_bad_sample="skip"``: the same resampled batches and skip count as
  JAX's on a dataset whose decodes fail at fixed indices; a dataset where
  every decode fails gives up after ``_MAX_RESAMPLES``.
- ``stall_s``: a worker stuck in a decode raises ``LoaderStallError``.
"""

import os
import os.path as osp
import threading

import numpy as np
import pytest

from raft_tpu.data import datasets as jds
from raft_tpu.data import loader as jloader
from raft_tpu_torch.data import datasets as ds
from raft_tpu_torch.data import frame_utils as fu
from raft_tpu_torch.data import loader
from raft_tpu_torch.data.png import write_png, write_ppm

CROP = (32, 48)
HW = (40, 56)
IMAGE_LEVELS = 3
FLOW_TOL = 1e-4
STAGES = ("chairs", "things", "sintel", "kitti")


def _frame(rng):
    # smooth-ish frames, as the augmentors' bounds were set on real ones
    base = rng.randint(0, 256, (HW[0] // 4 + 1, HW[1] // 4 + 1, 3))
    img = np.kron(base, np.ones((4, 4, 1)))[:HW[0], :HW[1]]
    return np.clip(img + rng.randint(-8, 9, img.shape), 0, 255).astype(
        np.uint8)


def _flow(rng):
    return (3 * rng.randn(*HW, 2)).astype(np.float32)


def _sparse_png(path, rng):
    px = np.concatenate([64 * _flow(rng) + 2 ** 15,
                         rng.rand(*HW, 1) > 0.3], -1).astype(np.uint16)
    write_png(path, px)


def write_layouts(root):
    """Every stage's datasets under ``root``: chairs 3 samples (2 in the
    training split), things 3 pairs per direction and pass, Sintel 2 pairs
    per pass, KITTI 2, HD1K 2."""
    rng = np.random.RandomState(0)
    d = osp.join(root, "FlyingChairs_release", "data")
    os.makedirs(d)
    for i in range(3):
        write_ppm(osp.join(d, f"{i:05d}_img1.ppm"), _frame(rng))
        write_ppm(osp.join(d, f"{i:05d}_img2.ppm"), _frame(rng))
        fu.write_flow(osp.join(d, f"{i:05d}_flow.flo"), _flow(rng))
    np.savetxt(osp.join(d, "chairs_split.txt"), [1, 2, 1], fmt="%d")

    t = osp.join(root, "FlyingThings3D")
    for dstype in ("frames_cleanpass", "frames_finalpass"):
        d = osp.join(t, dstype, "TRAIN", "A", "0000", "left")
        os.makedirs(d)
        for i in range(6, 10):
            write_png(osp.join(d, f"{i:04d}.png"), _frame(rng))
    for direction, tag in (("into_future", "IntoFuture"),
                           ("into_past", "IntoPast")):
        d = osp.join(t, "optical_flow", "TRAIN", "A", "0000", direction,
                     "left")
        os.makedirs(d)
        for i in range(6, 10):
            flow3 = np.concatenate([_flow(rng), np.zeros((*HW, 1),
                                                         np.float32)], -1)
            fu.write_pfm(osp.join(d, f"OpticalFlow{tag}_{i:04d}_L.pfm"),
                         flow3)

    for dstype in ("clean", "final"):
        d = osp.join(root, "Sintel", "training", dstype, "alley_1")
        os.makedirs(d)
        for i in range(3):
            write_png(osp.join(d, f"frame_{i + 1:04d}.png"), _frame(rng))
    d = osp.join(root, "Sintel", "training", "flow", "alley_1")
    os.makedirs(d)
    for i in range(2):
        fu.write_flow(osp.join(d, f"frame_{i + 1:04d}.flo"), _flow(rng))

    k = osp.join(root, "KITTI", "training")
    os.makedirs(osp.join(k, "image_2"))
    os.makedirs(osp.join(k, "flow_occ"))
    for i in range(2):
        for s in ("10", "11"):
            write_png(osp.join(k, "image_2", f"{i:06d}_{s}.png"), _frame(rng))
        _sparse_png(osp.join(k, "flow_occ", f"{i:06d}_10.png"), rng)

    h = osp.join(root, "HD1k")
    os.makedirs(osp.join(h, "hd1k_flow_gt", "flow_occ"))
    os.makedirs(osp.join(h, "hd1k_input", "image_2"))
    for i in range(3):
        write_png(osp.join(h, "hd1k_input", "image_2", f"000000_{i:04d}.png"),
                  _frame(rng))
        _sparse_png(osp.join(h, "hd1k_flow_gt", "flow_occ",
                             f"000000_{i:04d}.png"), rng)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("datasets"))
    write_layouts(root)
    return root


def _hold_sample(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape == CROP + (3,)
        assert np.abs(g - w).max() <= IMAGE_LEVELS
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=FLOW_TOL)
    np.testing.assert_array_equal(got[3], want[3])


def _members(mix):
    parts = mix.datasets if hasattr(mix, "datasets") else [mix]
    return [(type(d).__name__, len(d)) for d in parts]


@pytest.mark.parametrize("stage", STAGES)
def test_fetch_dataset_matches_jax(data_root, stage):
    mix = ds.fetch_dataset(stage, CROP, data_root)
    jmix = jds.fetch_dataset(stage, CROP, data_root)
    assert len(mix) == len(jmix)
    assert _members(mix) == _members(jmix)
    want_len = {"chairs": 2, "things": 12,
                "sintel": 100 * 2 + 100 * 2 + 200 * 2 + 5 * 2 + 6,
                "kitti": 2}[stage]
    assert len(mix) == want_len
    if stage == "sintel":
        assert [n for _, n in _members(mix)] == [200, 200, 400, 10, 6]
    mix.reseed(11)
    jmix.reseed(11)
    for i in (0, len(mix) // 2, len(mix) - 1):
        _hold_sample(mix[i], jmix[i])


def _chairs(data_root):
    return (ds.fetch_dataset("chairs", CROP, data_root),
            jds.fetch_dataset("chairs", CROP, data_root))


@pytest.mark.parametrize("wire", ["uint8", "float32"])
def test_prefetch_loader_matches_jax(data_root, wire):
    sintel = [ds.MpiSintel({"crop_size": CROP}, root=osp.join(data_root,
                                                              "Sintel")),
              jds.MpiSintel({"crop_size": CROP}, root=osp.join(data_root,
                                                               "Sintel"))]
    for d in sintel:
        d.image_list, d.flow_list = 3 * d.image_list, 3 * d.flow_list
    kw = dict(batch_size=2, num_workers=1, seed=5, wire_dtype=wire)
    ours = loader.PrefetchLoader(sintel[0], **kw)
    theirs = jloader.PrefetchLoader(sintel[1], **kw)
    assert len(ours) == len(theirs) == 3
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert {k: v.dtype for k, v in g.items()} == {
                k: v.dtype for k, v in w.items()}
            for b in range(2):
                _hold_sample([g[k][b].astype(np.float32)
                              for k in ("image1", "image2", "flow", "valid")],
                             [w[k][b].astype(np.float32)
                              for k in ("image1", "image2", "flow", "valid")])


def test_uint8_wire():
    rng = np.random.RandomState(0)
    sample = (rng.randint(0, 256, (4, 6, 3)).astype(np.float32),
              rng.randint(0, 256, (4, 6, 3)).astype(np.float32),
              rng.randn(4, 6, 2).astype(np.float32),
              (rng.rand(4, 6) > 0.5).astype(np.float32))
    batch = loader._collate([sample, sample], "uint8", check=True)
    assert {k: v.dtype for k, v in batch.items()} == {
        "image1": np.uint8, "image2": np.uint8, "flow": np.float32,
        "valid": np.uint8}
    for k, v in zip(("image1", "image2", "flow", "valid"), sample):
        np.testing.assert_array_equal(batch[k][1].astype(np.float32), v)
    with pytest.raises(ValueError, match="integral"):
        loader._collate([(sample[0] + 0.5,) + sample[1:]], "uint8",
                        check=True)
    with pytest.raises(ValueError, match="0/1"):
        loader._collate([sample[:3] + (sample[3] * 0.5,)], "uint8",
                        check=True)


class Flaky:
    """An in-memory dataset whose decodes fail at ``bad`` indices (all of
    them with ``bad=None``)."""

    def __init__(self, n=8, bad=(1, 5)):
        rng = np.random.RandomState(1)
        self.items = [(rng.randint(0, 256, (4, 6, 3)).astype(np.float32),
                       rng.randint(0, 256, (4, 6, 3)).astype(np.float32),
                       rng.randn(4, 6, 2).astype(np.float32),
                       np.ones((4, 6), np.float32)) for _ in range(n)]
        self.bad = bad

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        if self.bad is None or i in self.bad:
            raise OSError(f"decode of sample {i} failed")
        return self.items[i]


def test_on_bad_sample_skip_matches_jax():
    kw = dict(batch_size=2, num_workers=1, seed=3, on_bad_sample="skip")
    ours = loader.PrefetchLoader(Flaky(), **kw)
    theirs = jloader.PrefetchLoader(Flaky(), **kw)
    with pytest.warns(UserWarning, match="skipped bad sample"):
        got = list(ours)
    with pytest.warns(UserWarning, match="skipped bad sample"):
        want = list(theirs)
    assert ours.bad_samples == theirs.bad_samples == 2
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(OSError, match="decode"):
        list(loader.PrefetchLoader(Flaky(), batch_size=2, num_workers=1))
    with pytest.warns(UserWarning):
        with pytest.raises(RuntimeError, match="gave up"):
            list(loader.PrefetchLoader(Flaky(bad=None), **kw))


def test_stall_raises_loader_stall_error():
    release = threading.Event()

    class Stuck(Flaky):
        def __getitem__(self, i):
            release.wait(30)
            return self.items[i]

    try:
        with pytest.raises(loader.LoaderStallError, match="stall_s"):
            next(iter(loader.PrefetchLoader(Stuck(), batch_size=2,
                                            num_workers=1, stall_s=0.2)))
    finally:
        release.set()
