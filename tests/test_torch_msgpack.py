"""The port's flax ``.msgpack`` codec (``raft_tpu_torch.tools.msgpack``) and
the weights it carries (``tools.convert``), against flax and ``raft_tpu``.

- The decoder reads the trained small fixture leaf for leaf, bitwise, as
  ``flax.serialization.msgpack_restore`` does, and the encoder writes the
  fixture's own bytes back from that tree.
- The encoder's bytes restore through flax's ``from_bytes`` /
  ``msgpack_restore``: chunked leaves (both sides' ``MAX_CHUNK_SIZE`` set
  small), numpy scalars, a bf16 leaf (no numpy dtype: a ``torch.bfloat16``
  tensor through a uint16 view), complex numbers and every int width;
  flax's bytes of the same trees decode to the same leaves.
- A truncated buffer, trailing bytes, an unknown extension code or type
  byte, and an array whose bytes do not fill its shape raise
  ``CorruptCheckpointError``; a file whose manifest disagrees is refused
  before it is decoded; the ``ckpt.msgpack_write`` site fires in
  ``save_converted``.
- ``load_weights`` gives bitwise the same model for the fixture's
  ``.msgpack`` and ``.pth``; ``flax_from_state_dict`` inverts
  ``state_dict_from_flax`` on JAX's own variable trees, basic and small.
- The convert CLI's ``main`` writes a file that
  ``raft_tpu.tools.convert.load_converted`` loads, and ``raft_tpu``'s
  ``RAFT`` on it gives the port's flow within 5e-4 px (the ROADMAP's
  end-to-end bound) on a crop of the demo frames.
"""

import glob
import os
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.models import RAFT as JaxRAFT
from raft_tpu.tools.convert import load_converted
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.testing import faults
from raft_tpu_torch.tools import msgpack as mp
from raft_tpu_torch.tools.convert import (CorruptCheckpointError,
                                          flax_from_state_dict, load_weights,
                                          main, manifest_path, save_converted,
                                          state_dict_from_flax)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURES = osp.join(REPO, "tests", "fixtures")
MSGPACK = osp.join(FIXTURES, "raft-small-cputrained.msgpack")
PTH = osp.join(FIXTURES, "raft-small-cputrained.pth")


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _same_leaf(a, b):
    if isinstance(a, torch.Tensor):
        b = torch.as_tensor(np.asarray(b).view(np.uint16)).view(torch.bfloat16)
        return a.dtype == b.dtype and torch.equal(a, b)
    return (np.asarray(a).dtype == np.asarray(b).dtype
            and np.array_equal(a, b) and type(a) is type(b))


def test_decoder_reads_the_fixture_bitwise_as_flax():
    data = open(MSGPACK, "rb").read()
    got, want = mp.unpackb(data), serialization.msgpack_restore(data)
    fg, fw = _flat(got), _flat(want)
    assert [k for k, _ in fg] == [k for k, _ in fw] and len(fg) == 106
    for (k, a), (_, b) in zip(fg, fw):
        assert _same_leaf(a, b), k
    assert mp.packb(got) == data


def _trees():
    rng = np.random.RandomState(0)
    return {
        "arrays": {"w": rng.randn(3, 4, 5).astype(np.float32),
                   "i": np.arange(-5, 7, dtype=np.int64),
                   "u": np.arange(6, dtype=np.uint8).reshape(2, 3),
                   "empty": np.zeros((0, 3), np.float16),
                   "b": np.array([True, False])},
        "scalars": {"f32": np.float32(3.5), "i64": np.int64(-7),
                    "f64": np.float64(2.25), "bool": np.bool_(True)},
        "python": {"ints": {f"i{j:02d}": v for j, v in enumerate([
                       0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1,
                       -32, -33, -128, -129, -32768, -32769,
                       -2 ** 31 - 1])},
                   "float": 1.5, "none": None, "t": True, "f": False,
                   "str": "x" * 40, "long": "y" * 300, "complex": 1 - 2j},
        "many": {f"k{i:02d}": np.float32(i) for i in range(20)},
    }


@pytest.mark.parametrize("name", ["arrays", "scalars", "python", "many"])
def test_encoder_round_trips_through_flax(name):
    tree = _trees()[name]
    data = mp.packb(tree)
    assert data == serialization.msgpack_serialize(tree)
    for back in (serialization.msgpack_restore(data), mp.unpackb(data)):
        for (k, a), (_, b) in zip(_flat(back), _flat(tree)):
            assert _same_leaf(a, b) if not isinstance(b, (int, float))\
                else a == b, k
    target = jax.tree_util.tree_map(lambda x: x, tree)
    restored = serialization.from_bytes(target, data)
    assert [k for k, _ in _flat(restored)] == [k for k, _ in _flat(tree)]


def test_bfloat16_leaf_round_trips():
    t = torch.randn(4, 6, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    data = mp.packb({"params": {"w": t, "s": t[1, 2]}})
    back = serialization.msgpack_restore(data)["params"]
    assert back["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32),
                                  t.float().numpy())
    assert float(back["s"]) == float(t[1, 2])
    flax_bytes = serialization.msgpack_serialize(
        {"params": {"w": jnp.asarray(back["w"]), "s": jnp.asarray(back["s"])}})
    assert flax_bytes == data
    mine = mp.unpackb(flax_bytes)["params"]
    assert mine["w"].dtype == torch.bfloat16 and torch.equal(mine["w"], t)
    assert mine["s"].dtype == torch.bfloat16 and torch.equal(mine["s"],
                                                             t[1, 2])


@pytest.mark.parametrize("leaf", [
    np.arange(30, dtype=np.float32).reshape(5, 6),
    np.arange(9, dtype=np.int64),
    "bf16"])
def test_chunked_leaves_round_trip(monkeypatch, leaf):
    """flax cuts a leaf of more than ``MAX_CHUNK_SIZE`` bytes into a
    ``__msgpack_chunked_array__`` map; with both limits at 16 bytes each
    side reads the other's chunks."""
    if isinstance(leaf, str):
        leaf = torch.arange(24, dtype=torch.float32).reshape(4, 6).to(
            torch.bfloat16)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
    monkeypatch.setattr(mp, "MAX_CHUNK_SIZE", 16)
    ours = mp.packb({"w": leaf})
    want = (leaf.float().numpy() if isinstance(leaf, torch.Tensor)
            else leaf)
    back = serialization.msgpack_restore(ours)["w"]
    np.testing.assert_array_equal(np.asarray(back, np.float32)
                                  if isinstance(leaf, torch.Tensor)
                                  else back, want)
    if not isinstance(leaf, torch.Tensor):
        flax_bytes = serialization.msgpack_serialize({"w": leaf})
        assert b"__msgpack_chunked_array__" in flax_bytes
        assert flax_bytes == ours
        np.testing.assert_array_equal(mp.unpackb(flax_bytes)["w"], leaf)
    else:
        got = mp.unpackb(ours)["w"]
        assert got.dtype == torch.bfloat16 and torch.equal(got, leaf)


def _ext(code, payload):
    return bytes([0xC7, len(payload), code & 0xFF]) + payload


@pytest.mark.parametrize("case", [
    "truncated", "trailing", "ext_code", "type_byte", "short_array",
    "bad_dtype", "fixture_cut"])
def test_corrupt_buffers_raise(case):
    good = mp.packb({"params": {"w": np.arange(6, dtype=np.float32)}})
    data = {
        "truncated": good[:-3],
        "trailing": good + b"\x00",
        "ext_code": b"\x81\xa1w" + _ext(9, b"\x00\x01"),
        "type_byte": b"\x81\xa1w\xc1",
        "short_array": b"\x81\xa1w" + _ext(1, mp.packb(((2, 3), "float32",
                                                       b"\x00" * 20))),
        "bad_dtype": b"\x81\xa1w" + _ext(1, mp.packb(((1,), "notatype",
                                                     b"\x00" * 4))),
        "fixture_cut": open(MSGPACK, "rb").read()[:100000],
    }[case]
    with pytest.raises(CorruptCheckpointError):
        mp.unpackb(data)


def test_load_refuses_a_truncated_file_and_a_bad_manifest(tmp_path):
    data = open(MSGPACK, "rb").read()
    path = str(tmp_path / "cut.msgpack")
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    with pytest.raises(CorruptCheckpointError, match="truncated"):
        load_weights(path, RAFTConfig(small=True))
    good = str(tmp_path / "good.msgpack")
    save_converted(mp.unpackb(data), good)
    raw = bytearray(open(good, "rb").read())
    raw[1000] ^= 0xFF
    with open(good, "wb") as f:
        f.write(raw)
    with pytest.raises(CorruptCheckpointError, match="integrity"):
        load_weights(good, RAFTConfig(small=True))


@pytest.mark.parametrize("kind", ["raise", "corrupt"])
def test_save_converted_fault_site(tmp_path, kind):
    """``ckpt.msgpack_write``: a raise in the window before the rename
    leaves no file; a corruption of the finished file is caught by its
    manifest."""
    path = str(tmp_path / "w.msgpack")
    tree = mp.unpackb(open(MSGPACK, "rb").read())
    faults.arm([{"site": "ckpt.msgpack_write", "at": 1, "kind": kind}])
    try:
        if kind == "raise":
            with pytest.raises(faults.FaultInjected):
                save_converted(tree, path)
            assert os.listdir(tmp_path) == []
        else:
            save_converted(tree, path)
            assert osp.exists(manifest_path(path))
            with pytest.raises(CorruptCheckpointError):
                load_weights(path, RAFTConfig(small=True))
    finally:
        faults.disarm()


def test_msgpack_and_pth_load_the_same_model():
    a = load_weights(MSGPACK, RAFTConfig(small=True)).state_dict()
    b = load_weights(PTH, RAFTConfig(small=True)).state_dict()
    assert a.keys() == b.keys() and len(a) == 106
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("small", [False, True])
def test_flax_from_state_dict_inverts_state_dict_from_flax(small, tmp_path):
    """On JAX's own variables: the tree comes back leaf for leaf, and the
    port's model written with ``save_converted`` reads back bitwise and
    restores through flax's ``from_bytes`` onto JAX's variable shapes."""
    img = jnp.zeros((1, 32, 32, 3))
    variables = jax.tree_util.tree_map(np.asarray, JaxRAFT(
        JaxConfig(small=small)).init(jax.random.PRNGKey(0), img, img,
                                     iters=1))
    back = flax_from_state_dict(state_dict_from_flax(variables))
    fv, fb = _flat(dict(variables)), _flat(back)
    assert [k for k, _ in fv] == [k for k, _ in fb]
    for (k, a), (_, b) in zip(fv, fb):
        assert a.shape == b.shape and np.array_equal(a, b), k
    model = RAFT(RAFTConfig(small=small), torch.Generator().manual_seed(1))
    path = str(tmp_path / "m.msgpack")
    save_converted(flax_from_state_dict(model.state_dict()), path)
    loaded = load_weights(path, RAFTConfig(small=small)).state_dict()
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(loaded[k], v), k
    shapes = jax.eval_shape(lambda: variables)
    restored = serialization.from_bytes(shapes, open(path, "rb").read())
    assert [k for k, _ in _flat(restored)] == [k for k, _ in fv]


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The convert CLI's output for the fixture, and ``raft_tpu``'s load
    of it."""
    path = str(tmp_path_factory.mktemp("cli") / "small.msgpack")
    main([PTH, path, "--small"])
    return path, load_converted(path, JaxConfig(small=True))


def test_convert_cli_writes_what_raft_tpu_loads(converted):
    path, variables = converted
    assert open(path, "rb").read() == open(MSGPACK, "rb").read()
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    want = load_weights(PTH, RAFTConfig(small=True)).state_dict()
    for k, v in want.items():
        assert torch.equal(sd[k], v), k


def test_jax_flow_on_the_port_written_msgpack_matches_the_port(converted):
    from PIL import Image

    path, variables = converted
    frames = sorted(glob.glob(osp.join(REPO, "demo-frames", "*.png")))[:2]
    im = [np.asarray(Image.open(f).convert("RGB"), np.float32)[
        120:184, 300:428][None] for f in frames]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = load_weights(path, RAFTConfig(small=True)).eval()
        with torch.no_grad():
            got = model(torch.from_numpy(im[0]), torch.from_numpy(im[1]),
                        iters=12)[1].numpy()
    finally:
        torch.set_num_threads(n)
    want = np.asarray(JaxRAFT(JaxConfig(small=True)).apply(
        variables, jnp.asarray(im[0]), jnp.asarray(im[1]), iters=12,
        test_mode=True)[1])
    assert float(np.abs(got - want).max()) <= 5e-4
    assert float(np.abs(want).max()) > 0.5
