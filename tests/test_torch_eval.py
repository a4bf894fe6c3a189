"""The port's evaluation (M7) and its data readers against the JAX package.

- Data: the port's PNG codec (``data/png.py``, numpy + zlib, standing in
  for PIL and cv2, which the card's machine lacks) decodes the Sintel demo
  frames (RGB, Sub and Paeth rows) bitwise as PIL does, 16-bit KITTI flow
  PNGs bitwise as JAX's ``read_flow_kitti`` (cv2) does, and what it writes
  reads back equal through PIL and cv2; ``.flo``, ``.pfm`` and PPM files
  round-trip and equal JAX's readers; ``forward_interpolate`` equals JAX's
  bitwise.
- Validators: tiny datasets written to ``tmp_path`` in each on-disk layout
  (KITTI, Sintel training and test, FlyingChairs) go through the port's and
  JAX's validators with the trained small fixture: EPE within 5e-4 px (the
  ROADMAP's end-to-end bound) and F1 within one pixel's share; the metric
  math on stub datasets, as ``tests/test_evaluation.py`` pins it; shape
  bucketing and crop; the warm-start chain and its files;
  ``FileNotFoundError`` for data that is not staged; ``cli/evaluate.main``
  end to end with ``--device cpu``.
"""

import glob
import os
import os.path as osp
import zlib

import numpy as np
import pytest
import torch

import cv2
from PIL import Image

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.data import frame_utils as jfu
from raft_tpu.evaluation import evaluate as jev
from raft_tpu.ops.interp import forward_interpolate as jax_forward_interpolate
from raft_tpu.tools.convert import load_pth as jax_load_pth
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.data import frame_utils as fu
from raft_tpu_torch.data import png
from raft_tpu_torch.evaluation import evaluate as ev
from raft_tpu_torch.ops.interp import forward_interpolate
from raft_tpu_torch.tools.convert import load_pth

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(REPO, "tests", "fixtures", "raft-small-cputrained.pth")
FRAMES = sorted(glob.glob(osp.join(REPO, "demo-frames", "*.png")))
SMALL = RAFTConfig(small=True)
ITERS = 12


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Run the port's CPU ops on one thread: the suite runs in parallel
    workers, and torch's default of one thread per core oversubscribes the
    host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_png_decodes_demo_frame_like_pil():
    got = png.read_png(FRAMES[0])
    want = np.asarray(Image.open(FRAMES[0]))
    assert got.dtype == np.uint8 and got.shape == (436, 1024, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,shape", [("RGB", (37, 53, 3)), ("L", (40, 33)),
                                        ("RGBA", (21, 17, 4)),
                                        ("LA", (9, 11, 2))])
def test_png_decodes_every_row_filter(tmp_path, mode, shape):
    """PIL's optimizing encoder picks among all five row filters."""
    rng = np.random.RandomState(len(mode))
    img = (rng.rand(*shape) * 40).astype(np.uint8).cumsum(axis=1).astype(np.uint8)
    Image.fromarray(img, mode).save(tmp_path / "f.png", optimize=True)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "f.png")), img)


@pytest.mark.parametrize("dtype,shape", [(np.uint8, (5, 7)),
                                         (np.uint8, (6, 9, 3)),
                                         (np.uint8, (6, 9, 4)),
                                         (np.uint16, (8, 8)),
                                         (np.uint16, (11, 13, 3))])
def test_png_writes_what_pil_and_cv2_read(tmp_path, dtype, shape):
    rng = np.random.RandomState(0)
    img = rng.randint(0, np.iinfo(dtype).max + 1, size=shape).astype(dtype)
    path = str(tmp_path / "w.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), img)
    via_cv2 = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:   # cv2 stores B, G, R(, A)
        via_cv2 = via_cv2[..., [2, 1, 0, 3][:img.shape[2]]]
    np.testing.assert_array_equal(via_cv2, img)
    if dtype == np.uint8:
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_png_refuses_palette_and_interlaced(tmp_path):
    img = Image.fromarray(np.zeros((4, 4, 3), np.uint8)).convert("P")
    img.save(tmp_path / "p.png")
    with pytest.raises(ValueError, match="palette"):
        png.read_png(str(tmp_path / "p.png"))
    # PIL writes no interlaced PNGs: set the IHDR's interlace byte by hand
    data = bytearray(png.encode_png(np.zeros((4, 4, 3), np.uint8)))
    data[28] = 1                               # IHDR body starts at byte 16
    data[29:33] = zlib.crc32(bytes(data[12:29])).to_bytes(4, "big")
    (tmp_path / "i.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        png.read_png(str(tmp_path / "i.png"))


def test_kitti_flow_png_reads_and_writes_like_jax(tmp_path):
    rng = np.random.RandomState(1)
    uv = (20 * rng.randn(9, 14, 2)).astype(np.float32)
    jfu.write_flow_kitti(str(tmp_path / "j.png"), uv)          # cv2 writes
    fu.write_flow_kitti(str(tmp_path / "p.png"), uv)           # the port
    for name in ("j.png", "p.png"):
        want = jfu.read_flow_kitti(str(tmp_path / name))
        got = fu.read_flow_kitti(str(tmp_path / name))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    # a sparse mask: the third channel is read, not assumed
    px = np.concatenate([64 * uv + 2 ** 15, rng.rand(9, 14, 1) > 0.5], -1)
    cv2.imwrite(str(tmp_path / "m.png"), px.astype(np.uint16)[..., ::-1])
    for g, w in zip(fu.read_flow_kitti(str(tmp_path / "m.png")),
                    jfu.read_flow_kitti(str(tmp_path / "m.png"))):
        np.testing.assert_array_equal(g, w)
    disp = rng.randint(0, 2 ** 16, (9, 14)).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "d.png"), disp)
    for g, w in zip(fu.read_disp_kitti(str(tmp_path / "d.png")),
                    jfu.read_disp_kitti(str(tmp_path / "d.png"))):
        np.testing.assert_array_equal(g, w)


def test_flo_pfm_ppm_round_trip_and_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    uv = rng.randn(7, 5, 2).astype(np.float32)
    fu.write_flow(str(tmp_path / "a.flo"), uv)
    for reader in (fu.read_flow, jfu.read_flow, fu.read_gen):
        np.testing.assert_array_equal(reader(str(tmp_path / "a.flo")), uv)
    for data in (rng.randn(6, 4, 3).astype(np.float32),
                 rng.randn(6, 4).astype(np.float32)):
        fu.write_pfm(str(tmp_path / "a.pfm"), data)
        np.testing.assert_array_equal(fu.read_pfm(str(tmp_path / "a.pfm")), data)
        np.testing.assert_array_equal(jfu.read_pfm(str(tmp_path / "a.pfm")), data)
        np.testing.assert_array_equal(fu.read_gen(str(tmp_path / "a.pfm")),
                                      jfu.read_gen(str(tmp_path / "a.pfm")))
    img = rng.randint(0, 256, (5, 8, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "c.ppm")
    np.testing.assert_array_equal(fu.read_gen(str(tmp_path / "c.ppm")), img)
    np.testing.assert_array_equal(
        np.asarray(jfu.read_gen(str(tmp_path / "c.ppm"))), img)


def test_forward_interpolate_matches_jax_bitwise():
    rng = np.random.RandomState(3)
    flow = (4 * rng.randn(12, 20, 2)).astype(np.float32)
    got = forward_interpolate(flow)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_forward_interpolate(flow))


# ---------------------------------------------------------------------------
# datasets on disk, through both packages' validators
# ---------------------------------------------------------------------------

def _crops(n, h=64, w=128):
    """``n + 1`` consecutive real Sintel frames, cropped."""
    return [png.read_png(f)[120:120 + h, 300:300 + w] for f in FRAMES[:n + 1]]


def _gt(rng, h=64, w=128):
    return (3 * rng.randn(h, w, 2)).astype(np.float32)


def write_kitti(root, n=2):
    frames = _crops(n)
    rng = np.random.RandomState(4)
    for split in ("training", "testing"):
        os.makedirs(osp.join(root, "KITTI", split, "image_2"))
    os.makedirs(osp.join(root, "KITTI", "training", "flow_occ"))
    for i in range(n):
        for split in ("training", "testing"):
            d = osp.join(root, "KITTI", split, "image_2")
            png.write_png(osp.join(d, f"{i:06d}_10.png"), frames[i])
            png.write_png(osp.join(d, f"{i:06d}_11.png"), frames[i + 1])
        px = np.concatenate([64 * _gt(rng) + 2 ** 15,
                             rng.rand(64, 128, 1) > 0.3], -1).astype(np.uint16)
        png.write_png(osp.join(root, "KITTI", "training", "flow_occ",
                               f"{i:06d}_10.png"), px)


def write_sintel(root, n=2):
    frames = _crops(n)
    rng = np.random.RandomState(5)
    for split in ("training", "test"):
        for dstype in ("clean", "final"):
            d = osp.join(root, "Sintel", split, dstype, "alley_1")
            os.makedirs(d)
            for i, f in enumerate(frames):
                png.write_png(osp.join(d, f"frame_{i + 1:04d}.png"), f)
    d = osp.join(root, "Sintel", "training", "flow", "alley_1")
    os.makedirs(d)
    for i in range(n):
        fu.write_flow(osp.join(d, f"frame_{i + 1:04d}.flo"), _gt(rng))


def write_chairs(root, n=2):
    frames = _crops(n)
    rng = np.random.RandomState(6)
    d = osp.join(root, "FlyingChairs_release", "data")
    os.makedirs(d)
    for i in range(n):
        Image.fromarray(frames[i]).save(osp.join(d, f"{i:05d}_img1.ppm"))
        Image.fromarray(frames[i + 1]).save(osp.join(d, f"{i:05d}_img2.ppm"))
        fu.write_flow(osp.join(d, f"{i:05d}_flow.flo"), _gt(rng))
    np.savetxt(osp.join(d, "chairs_split.txt"), [2] * n, fmt="%d")


@pytest.fixture(scope="module")
def fixture_weights():
    return load_pth(FIXTURE, SMALL), jax_load_pth(FIXTURE, JaxConfig(small=True))


def test_validators_match_jax(tmp_path, fixture_weights):
    model, variables = fixture_weights
    root = str(tmp_path)
    write_kitti(root)
    write_sintel(root)
    write_chairs(root)
    jcfg = JaxConfig(small=True)
    got = ev.validate_kitti(model, SMALL, ITERS, root, device="cpu")
    want = jev.validate_kitti(variables, jcfg, ITERS, root)
    assert abs(got["kitti-epe"] - want["kitti-epe"]) <= 5e-4
    n_valid = sum(float((png.read_png(f)[..., 2] > 0).sum()) for f in glob.glob(
        osp.join(root, "KITTI", "training", "flow_occ", "*.png")))
    assert abs(got["kitti-f1"] - want["kitti-f1"]) <= 100 / n_valid
    assert 0 < want["kitti-f1"] < 100
    got = ev.validate_sintel(model, SMALL, ITERS, root, batch_size=2,
                             device="cpu")
    want = jev.validate_sintel(variables, jcfg, ITERS, root, batch_size=2)
    assert sorted(got) == ["clean", "final"]
    for k in got:
        assert abs(got[k] - want[k]) <= 5e-4
    got = ev.validate_chairs(model, SMALL, ITERS, root, batch_size=2,
                             device="cpu")
    want = jev.validate_chairs(variables, jcfg, ITERS, root, batch_size=2)
    assert abs(got["chairs"] - want["chairs"]) <= 5e-4

    # the CLI end to end, on the CPU
    from raft_tpu_torch.cli.evaluate import main

    res = main(["--model", FIXTURE, "--small", "--dataset", "kitti",
                "--data_root", root, "--device", "cpu"])
    assert res == ev.validate_kitti(model, SMALL, data_root=root,
                                    device="cpu")


def test_submissions_match_jax(tmp_path, fixture_weights):
    """Both submission writers over the test layouts: the same files, the
    cold pair's flow within 5e-4 px of JAX's, every flow finite; KITTI's
    16-bit flow PNGs within a 1/64 px step."""
    model, variables = fixture_weights
    root = str(tmp_path)
    write_kitti(root)
    write_sintel(root)
    for pkg, m in (("port", model), ("jax", variables)):
        kw = dict(output_path=str(tmp_path / pkg / "sintel"), data_root=root)
        if pkg == "port":
            ev.create_sintel_submission(m, SMALL, ITERS, warm_start=True,
                                        device="cpu", **kw)
            ev.create_kitti_submission(
                m, SMALL, ITERS, str(tmp_path / pkg / "kitti"), root,
                device="cpu")
        else:
            jev.create_sintel_submission(m, JaxConfig(small=True), ITERS,
                                         warm_start=True, **kw)
            jev.create_kitti_submission(
                m, JaxConfig(small=True), ITERS,
                str(tmp_path / pkg / "kitti"), root)
    for sub in ("sintel", "kitti"):
        names = sorted(osp.relpath(p, tmp_path / "port" / sub) for p in glob.glob(
            str(tmp_path / "port" / sub / "**" / "*.*"), recursive=True))
        assert names == sorted(osp.relpath(p, tmp_path / "jax" / sub)
                               for p in glob.glob(str(tmp_path / "jax" / sub
                                                      / "**" / "*.*"),
                                                  recursive=True))
        assert len(names) == (4 if sub == "sintel" else 2)
    for dstype in ("clean", "final"):
        rel = osp.join("sintel", dstype, "alley_1", "frame0001.flo")
        got = fu.read_flow(str(tmp_path / "port" / rel))
        assert got.shape == (64, 128, 2) and np.abs(got).max() > 0.1
        np.testing.assert_allclose(got, jfu.read_flow(str(tmp_path / "jax" / rel)),
                                   atol=5e-4, rtol=0)
        warm = fu.read_flow(str(tmp_path / "port" / "sintel" / dstype /
                                "alley_1" / "frame0002.flo"))
        assert np.isfinite(warm).all()
    for name in ("000000_10.png", "000001_10.png"):
        got, valid = fu.read_flow_kitti(str(tmp_path / "port" / "kitti" / name))
        want, _ = jfu.read_flow_kitti(str(tmp_path / "jax" / "kitti" / name))
        assert valid.all() and got.shape == (64, 128, 2)
        np.testing.assert_allclose(got, want, atol=1 / 64 + 1e-6, rtol=0)


# ---------------------------------------------------------------------------
# metric math and plumbing, with stubbed forwards (tests/test_evaluation.py)
# ---------------------------------------------------------------------------

class FakeKITTI:
    """Two sparse-GT frames with hand-picked flows."""

    def __init__(self, *a, **k):
        h, w = 16, 16
        gt = np.zeros((h, w, 2), np.float32)
        gt[0, 0] = [10.0, 0.0]
        valid = np.zeros((h, w), np.float32)
        valid[0, 0] = 1.0   # one valid pixel per frame
        valid[0, 1] = 1.0   # gt zero here
        zeros = np.zeros((h, w, 3), np.float32)
        self.samples = [(zeros, zeros, gt, valid),
                        (zeros, zeros, np.zeros((h, w, 2), np.float32), valid)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def constant_forward(flow_value):
    """make_forward stub: prediction = constant flow everywhere."""

    def make_forward(config, iters, device="cuda"):
        def fwd(model, i1, i2):
            B, H, W, _ = i1.shape
            flow = torch.tensor(flow_value, dtype=torch.float32).expand(
                B, H, W, 2)
            return flow, flow

        return fwd, fwd

    return make_forward


@pytest.mark.parametrize("pred,f1,epe", [([6.0, 0.0], 100.0, (5.0 + 6.0) / 2),
                                         ([9.8, 0.0], 75.0, None)])
def test_kitti_f1_and_epe_math(monkeypatch, pred, f1, epe):
    """[6, 0]: every valid pixel an outlier (epe 4 with epe/|gt| 0.4, and
    epe 6 where gt is 0); [9.8, 0]: the first pixel's epe 0.2 is an
    inlier, three of four are outliers."""
    monkeypatch.setattr(ev, "make_forward", constant_forward(pred))
    monkeypatch.setattr(ev.ds, "KITTI", FakeKITTI)
    res = ev.validate_kitti(None, SMALL, device="cpu")
    assert res["kitti-f1"] == pytest.approx(f1)
    if epe is not None:
        assert res["kitti-epe"] == pytest.approx(epe)


class FakeSintelVaried:
    """5 frames (odd count -> trailing partial batch) with per-image GT."""

    def __init__(self, *a, split="training", dstype="clean", **k):
        h, w = 8, 8
        rng = np.random.RandomState(3)
        self.samples = []
        for _ in range(5):
            img = rng.rand(h, w, 3).astype(np.float32) * 255
            self.samples.append((img, img.copy(),
                                 rng.randn(h, w, 2).astype(np.float32),
                                 np.ones((h, w), np.float32)))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def image_dependent_forward(config, iters, device="cuda"):
    """Stub whose prediction depends on each image's content, so batching
    bugs (sample mix-ups, trailing-pad leakage) change the metric."""
    def fwd(model, i1, i2):
        flow = torch.stack([i1.mean(-1) * 0.01, i2.mean(-1) * 0.02], -1)
        return flow[:, ::8, ::8], flow

    return fwd, fwd


def test_sintel_metrics_independent_of_batch_size(monkeypatch):
    monkeypatch.setattr(ev, "make_forward", image_dependent_forward)
    monkeypatch.setattr(ev.ds, "MpiSintel", FakeSintelVaried)
    r1 = ev.validate_sintel(None, SMALL, batch_size=1, device="cpu")
    r3 = ev.validate_sintel(None, SMALL, batch_size=3, device="cpu")
    for k in ("clean", "final"):
        assert r1[k] == pytest.approx(r3[k], rel=1e-6) and r1[k] > 0


def test_shape_buckets_and_crop():
    """KITTI's frame sizes share one bucketed shape, and crop + unpad
    restores each frame exactly; JAX pads to the same values."""
    rng = np.random.RandomState(0)
    buckets = set()
    for h, w in [(375, 1242), (370, 1224), (374, 1238), (376, 1241)]:
        img = rng.rand(h, w, 3).astype(np.float32)
        i1, i2, padder, crop = ev._to_device_pair(img, img, "kitti", 64, "cpu")
        buckets.add(tuple(i1.shape))
        np.testing.assert_array_equal(padder.unpad(ev._crop(i1, crop))[0].numpy(),
                                      img)
        j1, _, _, jcrop = jev._to_device_pair(img, img, "kitti", bucket=64)
        assert jcrop == crop
        np.testing.assert_array_equal(i1.numpy(), np.asarray(j1))
    assert buckets == {(1, 384, 1280, 3)}
    img = np.zeros((375, 1242, 3), np.float32)
    i1, _, _, crop = ev._to_device_pair(img, img, "kitti", None, "cpu")
    assert tuple(i1.shape) == (1, 376, 1248, 3) and crop == (376, 1248)


class FakeSintelTestSplit:
    """Two sequences, so the warm-start chain must reset at the boundary."""

    def __init__(self, *a, **k):
        img = np.zeros((16, 16, 3), np.float32)
        self.samples = [(img, img, ("alley_1", 0)), (img, img, ("alley_1", 1)),
                        (img, img, ("market_6", 0))]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def test_warm_start_chain_and_files(monkeypatch, tmp_path):
    """Warm start uses flow_init for consecutive frames of one sequence,
    resets at sequence boundaries (evaluate.py:30-41), and writes
    frame%04d.flo named from 1 (evaluate.py:47-49)."""
    calls = {"cold": 0, "warm": 0}

    def make_forward(config, iters, device="cuda"):
        def fwd(model, i1, i2):
            calls["cold"] += 1
            flow = torch.ones((1, 16, 16, 2))
            return flow[:, ::8, ::8] * 0.5, flow

        def fwd_init(model, i1, i2, flow_init):
            calls["warm"] += 1
            assert tuple(np.shape(flow_init)) == (1, 2, 2, 2)
            flow = torch.full((1, 16, 16, 2), 2.0)
            return flow[:, ::8, ::8] * 0.5, flow

        return fwd, fwd_init

    monkeypatch.setattr(ev, "make_forward", make_forward)
    monkeypatch.setattr(ev.ds, "MpiSintel", FakeSintelTestSplit)
    ev.create_sintel_submission(None, SMALL, warm_start=True,
                                output_path=str(tmp_path / "sub"),
                                device="cpu")
    assert calls == {"cold": 4, "warm": 2}
    for dstype in ("clean", "final"):
        for seq, frame in [("alley_1", 1), ("alley_1", 2), ("market_6", 1)]:
            assert (tmp_path / "sub" / dstype / seq / f"frame{frame:04d}.flo"
                    ).exists()
    np.testing.assert_allclose(fu.read_flow(str(
        tmp_path / "sub" / "clean" / "alley_1" / "frame0002.flo")), 2.0)


@pytest.mark.parametrize("fn,match", [
    (ev.validate_chairs, "FlyingChairs"), (ev.validate_sintel, "Sintel"),
    (ev.validate_kitti, "KITTI"), (ev.create_sintel_submission, "Sintel"),
    (ev.create_kitti_submission, "KITTI")])
def test_unstaged_data_raises_file_not_found(tmp_path, fn, match):
    with pytest.raises(FileNotFoundError, match=match):
        fn(None, SMALL, data_root=str(tmp_path), device="cpu")


def test_training_data_waits_for_m13(tmp_path):
    """Training's data pipeline (M13) is ported: its datasets construct,
    and an unstaged stage mix raises ``FileNotFoundError``. JPEG frames,
    which no stage mix reads, decode too (ROADMAP M14)."""
    from raft_tpu_torch.data import datasets

    kitti = datasets.KITTI(aug_params={"crop_size": (64, 64)},
                           root=str(tmp_path))
    assert kitti.augmentor is not None and len(kitti) == 0
    for cls in (datasets.FlyingThings3D, datasets.HD1K):
        assert len(cls(root=str(tmp_path))) == 0
    with pytest.raises(FileNotFoundError, match="not staged"):
        datasets.fetch_dataset("chairs", (64, 64), data_root=str(tmp_path))
    from raft_tpu_torch.data.jpeg import write_jpeg
    gray = np.full((5, 7), 200, np.uint8)
    write_jpeg(str(tmp_path / "frame.jpg"), gray)
    np.testing.assert_array_equal(fu.read_gen(str(tmp_path / "frame.jpg")),
                                  gray)
