"""The port's native flow-file codec (``raft_tpu_torch.native``, g++ at first
use) against the port's numpy readers and the JAX package's
``raft_tpu.data.frame_utils``: every file reads and writes bitwise the same
through all three."""

import numpy as np
import pytest

from raft_tpu.data import frame_utils as jax_fu
from raft_tpu_torch import native
from raft_tpu_torch.data import frame_utils as fu


@pytest.fixture(scope="module")
def lib():
    assert native.available(), "g++ could not build raft_tpu_torch/native"
    return native.get_lib()


@pytest.mark.parametrize("shape", [(17, 23), (436, 1024), (1, 1)])
def test_flo_roundtrip_matches_numpy_and_jax(tmp_path, lib, shape):
    rng = np.random.RandomState(sum(shape))
    uv = (rng.randn(*shape, 2) * 20).astype(np.float32)
    a, b, c = (str(tmp_path / f"{n}.flo") for n in "abc")
    assert native.write_flo(a, uv)
    fu.write_flow_numpy(b, uv)
    jax_fu.write_flow(c, uv)
    raw = open(a, "rb").read()
    assert raw == open(b, "rb").read() == open(c, "rb").read()
    for p in (a, b, c):
        for read in (native.read_flo, fu.read_flow_numpy, fu.read_flow,
                     jax_fu.read_flow):
            np.testing.assert_array_equal(read(p), uv)


@pytest.mark.parametrize("color", [False, True])
@pytest.mark.parametrize("little_endian", [True, False])
def test_pfm_matches_numpy_and_jax(tmp_path, lib, color, little_endian):
    rng = np.random.RandomState(int(color) + 2 * int(little_endian))
    shape = (31, 45, 3) if color else (31, 45)
    data = rng.randn(*shape).astype(np.float32)
    path = str(tmp_path / "x.pfm")
    if little_endian:
        fu.write_pfm(path, data)
    else:     # a big-endian file: positive scale, '>f4' rows, bottom-up
        with open(path, "wb") as f:
            f.write(b"PF\n" if color else b"Pf\n")
            f.write(f"{shape[1]} {shape[0]}\n1.0\n".encode())
            f.write(np.flipud(data).astype(">f4").tobytes())
    out = native.read_pfm(path)
    np.testing.assert_array_equal(out, data)
    np.testing.assert_array_equal(fu.read_pfm_numpy(path), data)
    np.testing.assert_array_equal(jax_fu.read_pfm(path), data)
    ours, theirs = fu.read_gen(path), jax_fu.read_gen(path)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == theirs.dtype == np.float32


def test_frame_utils_takes_the_native_path(tmp_path, lib, monkeypatch):
    calls = []
    for name in ("read_flo", "write_flo", "read_pfm"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    uv = np.ones((3, 4, 2), np.float32)
    fu.write_flow(str(tmp_path / "a.flo"), uv)
    np.testing.assert_array_equal(fu.read_flow(str(tmp_path / "a.flo")), uv)
    fu.write_pfm(str(tmp_path / "a.pfm"), uv[..., 0])
    fu.read_pfm(str(tmp_path / "a.pfm"))
    assert calls == ["write_flo", "read_flo", "read_pfm"]


def test_bad_files_fall_back_to_numpy_semantics(tmp_path, lib):
    bad = tmp_path / "bad.flo"
    bad.write_bytes(b"not a flo file")
    assert native.read_flo(str(bad)) is None
    with pytest.raises(ValueError, match="magic"):
        fu.read_flow(str(bad))
    badp = tmp_path / "bad.pfm"
    badp.write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    assert native.read_pfm(str(badp)) is None
    with pytest.raises(ValueError, match="not a PFM"):
        fu.read_pfm(str(badp))
    with pytest.raises(ValueError, match=r"\(H, W, 2\)"):
        fu.write_flow(str(tmp_path / "x.flo"), np.zeros((2, 2, 3)))


def test_numpy_path_when_the_build_fails(tmp_path, monkeypatch):
    """Without g++ every native call returns None or False and the readers
    give the same arrays through numpy."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert not native.available()
    uv = np.arange(24, dtype=np.float32).reshape(3, 4, 2)
    p = str(tmp_path / "n.flo")
    assert not native.write_flo(p, uv) and native.read_flo(p) is None
    fu.write_flow(p, uv)
    np.testing.assert_array_equal(fu.read_flow(p), uv)
    np.testing.assert_array_equal(jax_fu.read_flow(p), uv)
