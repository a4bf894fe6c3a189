"""The port's flow video (``raft_tpu_torch.serving.video``) against the JAX
package's (cv2's MJPG ``VideoWriter``), and the CLIs that read JPEG frames
and write it.

Both AVIs are read with ``cv2.VideoCapture``: frame count, size and fps with
its default backend (FFmpeg) and with OpenCV's own MJPEG reader
(``CAP_OPENCV_MJPEG``), the pixels with the latter. FFmpeg's MJPEG decoder
has its own IDCT, chroma upsampling and colour conversion and reads either
file up to tens of levels away from libjpeg at chroma edges; OpenCV's reader
decodes each frame with libjpeg, the decoder the port's ``read_jpeg``
matches, so it is the one the port's own reading is held to.
"""

import glob
import json
import os
import os.path as osp

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from raft_tpu.serving.video import optical_flow_visualize as jax_visualize
from raft_tpu_torch.data.jpeg import decode_jpeg
from raft_tpu_torch.serving import video
from raft_tpu_torch.serving.video import optical_flow_visualize
from raft_tpu_torch.testing.avi import read_mjpg_avi
from raft_tpu_torch.utils.flow_viz import flow_to_image

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FRAMES = osp.join(REPO, "demo-frames")
SMALL_PTH = osp.join(REPO, "tests", "fixtures", "raft-small-cputrained.pth")


def _crops(n, h, w, y=100, x=200):
    return [np.asarray(Image.open(osp.join(FRAMES, f"frame_{16 + i:04d}.png"))
                       )[y:y + h, x:x + w] for i in range(n)]


def _smooth_flows(n, h, w, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / 40.0
    flows = []
    for _ in range(n):
        a, b, p, q = rng.uniform(1, 4, 4)
        flows.append(np.stack([a * np.sin(xx + p), b * np.cos(yy - q)],
                              -1).astype(np.float32))
    return flows


def _cv_read(path, backend):
    cap = cv2.VideoCapture(path, backend)
    assert cap.isOpened(), path
    meta = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            cap.get(cv2.CAP_PROP_FPS))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[..., ::-1])
    cap.release()
    return meta, frames


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("shape,with_images,fps", [
    ((96, 128), True, 30.0), ((38, 54), True, 24.0), ((64, 80), False, 10.0)])
def test_video_matches_jax_writer(tmp_path, shape, with_images, fps):
    h, w = shape
    n = 4
    flows = _smooth_flows(n, h, w)
    images = _crops(n, h, w) if with_images else None
    ours = optical_flow_visualize(flows, str(tmp_path / "port.avi"), fps=fps,
                                  images=images)
    theirs = jax_visualize(flows, str(tmp_path / "jax.avi"), fps=fps,
                           images=images)
    sources = [flow_to_image(f) if images is None else
               np.concatenate([im, flow_to_image(f)], 0)
               for im, f in zip(images or [None] * n, flows)]
    for backend in (cv2.CAP_ANY, cv2.CAP_OPENCV_MJPEG):
        meta_ours, _ = _cv_read(ours, backend)
        meta_theirs, _ = _cv_read(theirs, backend)
        assert meta_ours[:3] == meta_theirs[:3] == (n, w, sources[0].shape[0])
        assert meta_ours[3] == pytest.approx(meta_theirs[3]) == pytest.approx(
            fps)
    _, px_ours = _cv_read(ours, cv2.CAP_OPENCV_MJPEG)
    _, px_theirs = _cv_read(theirs, cv2.CAP_OPENCV_MJPEG)
    avi = read_mjpg_avi(ours)
    assert avi.fps == pytest.approx(fps) and avi.size == (
        w, sources[0].shape[0]) and len(avi.frames) == n
    for i, (a, b, src, jpg) in enumerate(zip(px_ours, px_theirs, sources,
                                             avi.frames)):
        p_ours, p_theirs = _psnr(a, src), _psnr(b, src)
        print(f"frame {i}: port {p_ours:.2f} dB, JAX (cv2) {p_theirs:.2f} dB")
        assert p_ours >= p_theirs - 0.5
        mine = decode_jpeg(jpg)
        diff = np.abs(mine.astype(np.int32) - a)
        print(f"frame {i}: read_mjpg_avi + read_jpeg against cv2: "
              f"{int((diff > 0).sum())} samples differ, max {int(diff.max())}")
        assert diff.max() <= 1


def test_odd_width_keeps_every_column(tmp_path):
    """cv2's writer (FFmpeg, 4:2:0) drops the last column of an odd width;
    the port's video keeps the source's size."""
    flows = _smooth_flows(2, 37, 53)
    ours = optical_flow_visualize(flows, str(tmp_path / "port.avi"),
                                  images=_crops(2, 37, 53))
    theirs = jax_visualize(flows, str(tmp_path / "jax.avi"),
                           images=_crops(2, 37, 53))
    assert _cv_read(ours, cv2.CAP_OPENCV_MJPEG)[0][:3] == (2, 53, 74)
    assert read_mjpg_avi(ours).size == (53, 74)
    print("cv2's video of a 53-wide frame:",
          _cv_read(theirs, cv2.CAP_OPENCV_MJPEG)[0][1:3])


def test_avi_layout(tmp_path):
    """RIFF 'AVI ': hdrl (avih, strl: strh vids/MJPG, strf MJPG), movi of
    word-aligned 00dc chunks, idx1 keyframes at offsets from 'movi'."""
    frames = [b"\xff\xd8abc\xff\xd9", b"\xff\xd8abcd\xff\xd9"]   # odd, even
    path = video.write_mjpg_avi(str(tmp_path / "x.avi"), frames, 16, 8,
                                29.97)
    data = open(path, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert int.from_bytes(data[4:8], "little") == len(data) - 8
    assert b"avih" in data and b"vidsMJPG" in data and data.count(
        b"MJPG") == 2
    movi = data.index(b"movi")
    idx = data.index(b"idx1")
    entries = np.frombuffer(data[idx + 8:], dtype=np.uint32).reshape(-1, 4)
    assert entries.shape[0] == 2 and (entries[:, 1] == 0x10).all()
    for (_, _, off, size), f in zip(entries, frames):
        assert data[movi + off:movi + off + 4] == b"00dc"
        assert data[movi + off + 8:movi + off + 8 + size] == f
        assert off % 2 == 0
    avi = read_mjpg_avi(path)
    assert avi.frames == frames and avi.size == (16, 8)
    assert avi.fps == pytest.approx(29.97)


def test_over_one_gib_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(video, "MAX_AVI_BYTES", 4096)
    flows = _smooth_flows(8, 64, 64)
    with pytest.raises(ValueError, match="1 GiB"):
        optical_flow_visualize(flows, str(tmp_path / "big.avi"))
    assert not os.path.exists(tmp_path / "big.avi")
    with pytest.raises(ValueError, match="no flows"):
        optical_flow_visualize([], str(tmp_path / "none.avi"))


def _jpeg_dir(tmp_path, n=3, h=64, w=96):
    d = tmp_path / "frames"
    d.mkdir()
    crops = _crops(n, h, w, y=150, x=400)
    for i, c in enumerate(crops):
        Image.fromarray(c).save(str(d / f"frame_{i:04d}.jpg"), quality=90)
    return str(d)


@pytest.fixture
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_parity_cli_writes_video_from_jpeg_frames(tmp_path, capsys,
                                                  _two_threads):
    from raft_tpu_torch.cli.parity import main

    path = _jpeg_dir(tmp_path)
    out = str(tmp_path / "flow.avi")
    main(["--model", SMALL_PTH, "--small", "--path", path, "--iters", "2",
          "--video", out, "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["pairs"] == 2 and line["video"] == out
    assert line["max_diff_px"] <= 5e-4
    avi = read_mjpg_avi(out)
    assert len(avi.frames) == 2 and avi.size == (96, 128)
    assert avi.fps == pytest.approx(30.0)
    frames = [decode_jpeg(f) for f in avi.frames]
    first = np.asarray(Image.open(sorted(glob.glob(path + "/*.jpg"))[0]))
    # the top half is the first frame as PIL decodes it, through the codec
    assert _psnr(frames[0][:64], first) > 30


def test_demo_cli_reads_jpeg_frames(tmp_path, _two_threads):
    from raft_tpu_torch.cli.demo import main

    path = _jpeg_dir(tmp_path)
    out = str(tmp_path / "demo_out")
    main(["--model", SMALL_PTH, "--small", "--path", path, "--out", out,
          "--iters", "2", "--device", "cpu"])
    written = sorted(os.listdir(out))
    assert written == ["frame_0000_flow.png", "frame_0001_flow.png"]
    pair = np.asarray(Image.open(osp.join(out, written[0])))
    first = np.asarray(Image.open(osp.join(path, "frame_0000.jpg")))
    assert pair.shape == (128, 96, 3)
    np.testing.assert_array_equal(pair[:64], first)
