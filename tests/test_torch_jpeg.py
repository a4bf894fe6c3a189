"""The port's JPEG codec (``raft_tpu_torch.data.jpeg``) against the JAX
package's reader, which is PIL (libjpeg-turbo), on files written by PIL and
by cv2.

- Decoder: the port's ``read_gen`` against ``raft_tpu.data.frame_utils
  .read_gen`` on a 436x1024 demo frame, an odd 37x53 crop and a gray frame,
  4:4:4, 4:2:2, 4:2:0 (and cv2's 4:4:0) at qualities 50, 75 and 95, cv2's
  restart intervals and optimized Huffman tables. The bound is one level;
  every case here is reached bitwise (the port runs libjpeg's islow IDCT,
  fancy upsampling and colour tables), so each asserts bitwise equality and
  prints how many pixels differ. Progressive, lossless, 12-bit, 4-component
  and truncated files raise ``ValueError``.
- Encoder: PIL decodes the port's files; their PSNR against the source is
  within 0.5 dB of PIL's own encoder at the same quality and sampling; the
  port reads its own files as PIL does.
"""

import io
import os.path as osp

import cv2
import numpy as np
import pytest
from PIL import Image

from raft_tpu.data import frame_utils as jax_fu
from raft_tpu_torch.data import frame_utils as fu
from raft_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg, write_jpeg

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FRAMES = osp.join(REPO, "demo-frames")
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}
CV_SAMPLING = {"4:4:4": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
               "4:2:2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
               "4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
               "4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def _frame(i=16):
    return np.asarray(Image.open(osp.join(FRAMES, f"frame_{i:04d}.png")))


def _image(kind):
    img = _frame()
    if kind == "crop":
        return np.ascontiguousarray(img[101:138, 203:256])      # 37x53
    if kind == "gray":
        return np.ascontiguousarray(img[..., 1])
    return img


def _pil_bytes(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _cv_bytes(img, params):
    ok, buf = cv2.imencode(".jpg", img[..., ::-1] if img.ndim == 3 else img,
                           params)
    assert ok
    return buf.tobytes()


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


def _assert_reads_as_jax(tmp_path, data, name):
    path = str(tmp_path / "frame.jpg")
    with open(path, "wb") as f:
        f.write(data)
    ref = np.asarray(jax_fu.read_gen(path))
    out = fu.read_gen(path)
    assert out.dtype == np.uint8 and out.shape == ref.shape, (out.shape,
                                                              ref.shape)
    diff = np.abs(out.astype(np.int32) - ref)
    print(f"{name}: {int((diff > 0).sum())} of {diff.size} samples differ, "
          f"max {int(diff.max())}")
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("kind", ["full", "crop"])
def test_decodes_pil_files_as_pil(tmp_path, kind, sampling, quality):
    data = _pil_bytes(_image(kind), quality=quality,
                      subsampling=SUBSAMPLING[sampling])
    _assert_reads_as_jax(tmp_path, data, f"PIL {kind} {sampling} q{quality}")


_CV_CASES = ([("full", s, 75) for s in CV_SAMPLING]
             + [("crop", s, q) for s in CV_SAMPLING for q in (50, 75, 95)])


@pytest.mark.parametrize("kind,sampling,quality", _CV_CASES)
def test_decodes_cv2_files_as_pil(tmp_path, kind, sampling, quality):
    data = _cv_bytes(_image(kind), [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, CV_SAMPLING[sampling]])
    _assert_reads_as_jax(tmp_path, data, f"cv2 {kind} {sampling} q{quality}")


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("writer", ["pil", "cv2"])
def test_decodes_gray_frames_as_pil(tmp_path, writer, quality):
    img = _image("gray")
    data = (_pil_bytes(img, quality=quality) if writer == "pil" else
            _cv_bytes(img, [cv2.IMWRITE_JPEG_QUALITY, quality]))
    _assert_reads_as_jax(tmp_path, data, f"{writer} gray q{quality}")


@pytest.mark.parametrize("kind", ["full", "crop"])
@pytest.mark.parametrize("interval", [1, 5, 64])
def test_restart_intervals(tmp_path, kind, interval):
    """cv2's ``IMWRITE_JPEG_RST_INTERVAL``: DRI, RST0-7 between intervals
    (the DC predictors restart), the last interval partial."""
    data = _cv_bytes(_image(kind), [cv2.IMWRITE_JPEG_RST_INTERVAL, interval])
    assert b"\xff\xdd" in data and (interval == 64 or b"\xff\xd0" in data)
    _assert_reads_as_jax(tmp_path, data, f"cv2 {kind} RST every {interval}")


def test_optimized_huffman_tables(tmp_path):
    data = _cv_bytes(_image("full"), [cv2.IMWRITE_JPEG_OPTIMIZE, 1])
    _assert_reads_as_jax(tmp_path, data, "cv2 optimized tables")


def test_adobe_rgb_without_transform(tmp_path):
    """An Adobe APP14 marker with transform 0 and no JFIF marker: the three
    components are R, G, B and go out with no colour conversion."""
    data = _pil_bytes(_image("crop"), keep_rgb=True)
    assert b"Adobe" in data and b"JFIF" not in data
    _assert_reads_as_jax(tmp_path, data, "Adobe RGB")


def _with_sof(data, marker=None, precision=None):
    """``data`` with its SOF0 marker byte or sample precision replaced."""
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def test_unsupported_modes_raise_value_error():
    img = _image("crop")
    base = _pil_bytes(img)
    cases = {
        "progressive": _pil_bytes(img, progressive=True),
        "lossless": _with_sof(base, marker=0xC3),
        "arithmetic": _with_sof(base, marker=0xC9),
        "12-bit": _with_sof(base, precision=12),
    }
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 4), np.uint8), "CMYK").save(buf, "JPEG")
    cases["4-component"] = buf.getvalue()
    for mode, data in cases.items():
        with pytest.raises(ValueError, match=mode):
            decode_jpeg(data)


@pytest.mark.parametrize("keep", [0.02, 0.5, 0.9, -2])
def test_truncated_file_raises_value_error(tmp_path, keep):
    """Cut in the headers, inside the scan, or just before EOI: PIL raises
    too (``image file is truncated``); the port raises ``ValueError``."""
    data = _pil_bytes(_image("full"), quality=75)
    cut = data[:int(len(data) * keep)] if keep > 0 else data[:keep]
    path = str(tmp_path / "cut.jpg")
    with open(path, "wb") as f:
        f.write(cut)
    with pytest.raises(OSError):
        np.asarray(jax_fu.read_gen(path))
    with pytest.raises(ValueError, match="truncated"):
        fu.read_gen(path)


def test_malformed_segments_raise_value_error():
    base = _pil_bytes(_image("crop"))
    sos = base.index(b"\xff\xda")
    cases = [b"", b"\x00\x01", b"\xff\xd8\xff\xdd\x00\x02\xff\xd9",
             b"\xff\xd8\xff\xda\x00\x02\xff\xd9",
             base[:sos] + b"\xff\xda\x00\x03\x01" + base[sos + 14:]]
    for data in cases:
        with pytest.raises(ValueError):
            decode_jpeg(data)


def test_corrupt_entropy_data_raises_value_error():
    data = bytearray(_pil_bytes(_image("crop")))
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    data[start:start + 8] = b"\xfe" * 8      # decoding goes off the rails
    with pytest.raises(ValueError, match="corrupt"):
        decode_jpeg(bytes(data))


@pytest.mark.parametrize("quality", [50, 75, 90, 95])
@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4"])
def test_encoder_psnr_matches_pil(quality, sampling):
    """PIL decodes the port's files; their PSNR is within 0.5 dB of PIL's
    encoder at the same quality and sampling on the demo frames; the port
    decodes them as PIL does."""
    for i in (16, 21):
        img = _frame(i)
        ours = encode_jpeg(img, quality, sampling)
        theirs = _pil_bytes(img, quality=quality,
                            subsampling=SUBSAMPLING[sampling])
        ours_px = np.asarray(Image.open(io.BytesIO(ours)))
        theirs_px = np.asarray(Image.open(io.BytesIO(theirs)))
        p_ours, p_theirs = _psnr(ours_px, img), _psnr(theirs_px, img)
        print(f"frame {i} q{quality} {sampling}: port {p_ours:.2f} dB "
              f"({len(ours)} B), PIL {p_theirs:.2f} dB ({len(theirs)} B)")
        assert p_ours >= p_theirs - 0.5
        np.testing.assert_array_equal(decode_jpeg(ours), ours_px)


@pytest.mark.parametrize("kind", ["crop", "gray"])
def test_encoder_odd_sizes_and_gray(tmp_path, kind):
    img = _image(kind)
    path = str(tmp_path / "x.jpg")
    write_jpeg(path, img)
    ref = np.asarray(Image.open(path))
    assert ref.shape == img.shape and _psnr(ref, img) > 30
    np.testing.assert_array_equal(fu.read_gen(path), ref)


@pytest.mark.parametrize("shape", [(1, 1, 3), (8, 8, 3), (9, 17), (16, 16, 3)])
def test_encoder_flat_and_tiny_images(tmp_path, shape):
    """Flat images have no AC coefficient at all (every block one DC code
    and an end of block); 1x1 is all padding but one pixel."""
    img = np.full(shape, 131, np.uint8)
    data = encode_jpeg(img)
    ref = np.asarray(Image.open(io.BytesIO(data)))
    assert ref.shape == img.shape and np.abs(ref.astype(int) - 131).max() <= 1
    np.testing.assert_array_equal(decode_jpeg(data), ref)


def test_encoder_default_beats_cv2_mjpg_frame_quality():
    """The writer's default (quality 90, 4:2:0) against the 33.93 dB that
    cv2's MJPG writer gave frame_0016 (the JAX package's video path)."""
    img = _frame(16)
    assert _psnr(decode_jpeg(encode_jpeg(img)), img) > 33.93


def test_encoder_rejects_bad_input():
    with pytest.raises(ValueError, match="uint8"):
        encode_jpeg(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(ValueError, match="subsampling"):
        encode_jpeg(np.zeros((8, 8, 3), np.uint8), subsampling="4:2:2")
