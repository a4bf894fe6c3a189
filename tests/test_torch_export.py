"""The port's export path and serving CLIs on the CPU.

``serving.export.export_program`` traces the serving function with
``torch.export`` (dynamic batch); on the CPU the kernels' operators run
their plain versions, so the saved and reloaded program equals the eager
forward bitwise at batch 1 and 2, in this process and in a fresh one that
imports only the port. The program holds the kernels' operators
(``raft_tpu_torch::corr_lookup``, ``::gru_gates``, ``::gru_blend``,
``::alt_corr_lookup``), whose fake implementations pass
``torch.library.opcheck``. ``cli/export`` and ``cli/parity`` run with
``--device cpu`` on the small fixture over frames written to ``tmp_path``;
the parity CLI's two paths agree within 5e-4 px. (The forward the program
traces is held to the JAX package's in ``test_torch_raft``.)
"""

import json
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.data.png import write_png
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.serving.export import (export_program, load_program,
                                           make_serving_fn)
from raft_tpu_torch.tools.convert import load_pth

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(REPO, "tests", "fixtures", "raft-small-cputrained.pth")
SMALL = RAFTConfig(small=True)
HW = (32, 48)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed, b, hw=HW):
    rng = np.random.RandomState(seed)
    a = np.floor(rng.rand(b, *hw, 3) * 256).astype(np.float32)
    return a, np.roll(a, (1, 2), axis=(1, 2))


def _ops(program):
    return {str(n.target) for n in program.graph.nodes
            if n.op == "call_function"
            and str(n.target).startswith("raft_tpu_torch.")}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    model = load_pth(FIXTURE, SMALL).eval()
    program = export_program(model, SMALL, iters=2, image_hw=HW)
    path = str(tmp_path_factory.mktemp("export") / "small.pt2")
    torch.export.save(program, path)
    return model, program, path, load_program(path)


def _eager(model, i1, i2):
    with torch.no_grad():
        return make_serving_fn(model, SMALL, 2)(torch.from_numpy(i1),
                                               torch.from_numpy(i2)).numpy()


@pytest.mark.parametrize("batch", [1, 2])
def test_saved_program_is_bitwise_eager(exported, batch):
    model, program, _, loaded = exported
    assert _ops(program) == {"raft_tpu_torch.corr_lookup.default"}
    i1, i2 = _images(batch, batch)
    want = _eager(model, i1, i2)
    got = loaded(torch.from_numpy(i1), torch.from_numpy(i2))
    assert got.shape == (batch, *HW, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        program.module()(torch.from_numpy(i1), torch.from_numpy(i2)).numpy(),
        want)


def test_program_loads_in_a_fresh_process(exported, tmp_path):
    """What a serving host does: a new interpreter that imports the port
    (which registers the operators) and nothing of JAX."""
    model, _, path, _ = exported
    i1, i2 = _images(3, 2)
    np.savez(tmp_path / "in.npz", i1=i1, i2=i2)
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)  # the sums in this process's order\n"
        "from raft_tpu_torch.serving.export import load_program\n"
        "x = np.load(sys.argv[2])\n"
        "out = load_program(sys.argv[1])(torch.from_numpy(x['i1']),"
        " torch.from_numpy(x['i2']))\n"
        "np.save(sys.argv[3], out.numpy())\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'raft_tpu')]\n")
    r = subprocess.run([sys.executable, "-c", code, path,
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npy")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  _eager(model, i1, i2))


def test_static_batch_program():
    model = load_pth(FIXTURE, SMALL).eval()
    program = export_program(model, SMALL, iters=1, image_hw=HW,
                             dynamic_batch=False)
    i1, i2 = _images(5, 1)
    with torch.no_grad():
        want = make_serving_fn(model, SMALL, 1)(torch.from_numpy(i1),
                                               torch.from_numpy(i2))
    np.testing.assert_array_equal(
        program.module()(torch.from_numpy(i1), torch.from_numpy(i2)).numpy(),
        want.numpy())
    with pytest.raises(Exception):
        program.module()(*[torch.from_numpy(np.concatenate([x, x]))
                           for x in (i1, i2)])
    with pytest.raises(ValueError, match="multiples of 8"):
        export_program(model, SMALL, iters=1, image_hw=(30, 48))


@pytest.mark.parametrize("kw,ops", [
    ({"corr_impl": "pallas", "gru_impl": "fused"},
     {"raft_tpu_torch.corr_lookup.default",
      "raft_tpu_torch.gru_gates.default", "raft_tpu_torch.gru_blend.default"}),
    ({"small": True, "alternate_corr": True, "corr_impl": "pallas"},
     {"raft_tpu_torch.alt_corr_lookup.default"})])
def test_program_holds_the_kernels_operators(kw, ops):
    cfg = RAFTConfig(**kw)
    model = RAFT(cfg).eval()
    program = export_program(model, cfg, iters=1, image_hw=(32, 32))
    assert _ops(program) == ops
    i1, i2 = _images(6, 2, (32, 32))
    with torch.no_grad():
        want = make_serving_fn(model, cfg, 1)(torch.from_numpy(i1),
                                             torch.from_numpy(i2))
    np.testing.assert_array_equal(
        program.module()(torch.from_numpy(i1), torch.from_numpy(i2)).numpy(),
        want.numpy())


def _op_args(name):
    rng = np.random.RandomState(7)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    coords = torch.from_numpy(
        (rng.rand(2, 4, 5, 2) * 5).astype(np.float32))
    if name == "corr_lookup":
        return coords, [t(2, 20, 4, 5), t(2, 20, 2, 2)], 2
    if name == "alt_corr_lookup":
        return t(2, 4, 5, 8), [t(2, 4, 5, 8), t(2, 2, 2, 8)], coords, 2
    zr = t(2, 8, 3, 3)      # the z and r halves are channel-slice views
    return zr[:, :4], zr[:, 4:], t(2, 4, 3, 3)


@pytest.mark.parametrize("name", ["corr_lookup", "gru_gates", "gru_blend",
                                  "alt_corr_lookup"])
def test_operators_pass_opcheck(name):
    op = getattr(torch.ops.raft_tpu_torch, name).default
    torch.library.opcheck(op, _op_args(name))


def test_export_cli(tmp_path, capsys):
    from raft_tpu_torch.cli.export import main

    out = str(tmp_path / "cli.pt2")
    main(["--model", FIXTURE, "--small", "--out", out, "--iters", "1",
          "--height", "32", "--width", "48", "--static_batch",
          "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["out"] == out and summary["batch"] == 1
    assert summary["bytes"] == osp.getsize(out)
    i1, i2 = _images(8, 1)
    assert load_program(out)(torch.from_numpy(i1),
                             torch.from_numpy(i2)).shape == (1, 32, 48, 2)


def test_parity_cli(tmp_path, capsys):
    from raft_tpu_torch.cli.parity import main

    rng = np.random.RandomState(9)
    base = np.floor(rng.rand(40, 60, 3) * 256).astype(np.uint8)
    for k in range(3):
        write_png(str(tmp_path / f"frame_{k:04d}.png"),
                  base[k:k + 30, 2 * k:2 * k + 44])
    main(["--model", FIXTURE, "--small", "--path", str(tmp_path),
          "--iters", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["pairs"] == 2 and len(summary["ms_engine"]) == 2
    assert summary["max_diff_px"] <= 5e-4
    assert summary["captures"] == 1 and summary["device"] == "cpu"
    assert lines[0].startswith("frame_0000.png: plain")
