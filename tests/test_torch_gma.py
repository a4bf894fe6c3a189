"""GMA in the port (``gma_heads=1``) against the plain GMA reference
(``flowbench/reference/gma.py``) on the CPU, from the same seeded weights
(``flowbench/weights_gma.py``, with W_qk's raised gain and a drawn γ).

The JAX package has no GMA, so the reference is the plain PyTorch model
after zacjiang/GMA; it imports nothing of the port. Bounds, each with its
reason:

- K6/K7's plain CPU path against the reference's einsums at N = 512:
  1e-5 of the largest value. The same float32 products summed in another
  order (the port's channels-last 1x1 conv and ``matmul`` against the
  reference's NCHW conv and ``einsum``), and the softmax's exponential
  passes a logit's rounding on as a relative one (logits up to ~10).
- The whole test-mode forward on the 128x256 Sintel crop, iters 2 and 3:
  1e-4 px mean endpoint distance. Float32 rounding in another order
  (measured 1.2e-6 and 1.6e-6 px), held at RAFT basic's one-step bound of
  ``flowbench/tests/test_flowbench_reference.py``.
- The aggregation is live: zeroing W_v, setting γ to 0 or transposing A
  moves the flow by more than 1000 times the parity bound (measured
  0.67-0.68 px).
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from flowbench import check, counts_gma, faults_gma, frames, run
from flowbench.kinds import serve, serve_gma
from flowbench.reference import gma as ref_gma
from flowbench.spec import HERE, ROOT, Cell
from flowbench.weights_gma import make_weights
from raft_tpu_torch import kernels
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.kernels.gma import gma_aggregate, gma_attention
from raft_tpu_torch.models import RAFT
from raft_tpu_torch.models import gma as port_gma
from raft_tpu_torch.models.layers import set_spatial
from raft_tpu_torch.ops.padding import InputPadder
from raft_tpu_torch.parallel.halo import Spatial
from raft_tpu_torch.serving import aot
from raft_tpu_torch.serving.engine import RAFTEngine
from raft_tpu_torch.serving.scheduler import MicroBatchScheduler
from raft_tpu_torch.tools.convert import load_pth
from raft_tpu_torch.training.train_step import (create_train_state,
                                                make_train_step)

SEED = 2 ** 40 + 3
CELL = "gma-1080p-serve-c8"
PARITY = 1e-4


def _config():
    with open(os.path.join(HERE, "configs", "gma.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cfg():
    return _config()


@pytest.fixture(scope="module")
def weights(cfg):
    return make_weights(cfg["architecture"], SEED, "cpu")


@pytest.fixture(scope="module")
def port(cfg, weights):
    model = RAFT(RAFTConfig(gma_heads=1, **cfg["program"])).eval()
    model.load_state_dict(weights)
    return model


@pytest.fixture(scope="module")
def pair():
    """A 124x250 crop of two consecutive Sintel frames (padded to 128x256
    by both models)."""
    fr = frames.sintel_frames()
    return (torch.from_numpy(fr[None, 3, 100:224, 300:550].copy()),
            torch.from_numpy(fr[None, 4, 100:224, 300:550].copy()))


def _port_flow(model, pair, iters):
    im1, im2 = pair
    padder = InputPadder(im1.shape)
    with torch.no_grad():
        _, up = model(*padder.pad(im1.float(), im2.float()), iters=iters)
    return padder.unpad(up)[0].numpy()


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_kernels_plain_path_matches_reference_einsum(weights):
    """K6 and K7's plain CPU path inside the port's modules against the
    reference's ``Attention`` and ``Aggregate`` on a 16x32 grid (N = 512),
    same weights, batch 2."""
    gen = torch.Generator().manual_seed(0)
    inp = torch.relu(torch.randn(2, 128, 16, 32, generator=gen))
    m = torch.relu(torch.randn(2, 128, 16, 32, generator=gen))
    ref_att = ref_gma.Attention(128, 1, 128, 160).eval()
    ref_agg = ref_gma.Aggregate(128, 1, 128).eval()
    att = port_gma.Attention(128, 1, 128).eval()
    agg = port_gma.Aggregate(128, 1, 128).eval()
    for module, prefix in ((ref_att, "att."), (att, "att."),
                           (ref_agg, "update_block.aggregator."),
                           (agg, "update_block.aggregator.")):
        module.load_state_dict({k[len(prefix):]: v for k, v in weights.items()
                                if k.startswith(prefix)})
    att.to(memory_format=torch.channels_last)
    agg.to(memory_format=torch.channels_last)
    with torch.no_grad():
        want_a = ref_att(inp)[:, 0]
        got_a = att(inp.contiguous(memory_format=torch.channels_last))
        assert got_a.shape == (2, 512, 512)
        assert _rel(got_a, want_a) < 1e-5
        # the rows are peaked, not uniform: the raised W_qk gain
        assert float(want_a.max(-1).values.median()) > 20 / 512
        want_g = ref_agg(want_a[:, None], m)
        got_g = agg(want_a, m.contiguous(memory_format=torch.channels_last))
        assert got_g.shape == m.shape
        assert got_g.is_contiguous(memory_format=torch.channels_last)
        assert _rel(got_g, want_g) < 1e-5
        assert _rel(want_g, m) > 0.1      # γ·A v is no rounding of m


def test_kernel_wrappers_take_the_plain_path_on_the_cpu():
    gen = torch.Generator().manual_seed(1)
    q, k, v, m = (torch.randn(2, 96, 16, generator=gen) for _ in range(4))
    gamma = torch.tensor([0.5])
    before = kernels.launch_counts()
    a = gma_attention(q, k, 0.25)
    want = torch.softmax(torch.einsum("bid,bjd->bij", 0.25 * q, k), -1)
    assert _rel(a, want) < 1e-6
    g = gma_aggregate(a, v, m, gamma)
    assert _rel(g, m + 0.5 * torch.einsum("bij,bjd->bid", a, v)) < 1e-6
    # a CPU launch is the plain version, not a kernel launch
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("n", [32400, 3645])
def test_attention_buffer_rows_start_16_bytes_apart(n):
    """K6's output, which K7 reads by 16-byte copies: a row stride that is
    a multiple of 4 floats whatever N, the (B, N, N) shape kept."""
    from raft_tpu_torch.kernels.gma import _aligned, _attention_buffer

    buf = _attention_buffer(2, n, "meta")
    assert buf.shape == (2, n, n)
    assert buf.stride(2) == 1 and buf.stride(1) % 4 == 0
    assert buf.stride(1) - n < 4
    assert _aligned(torch.empty(1, 8, 8)) and not _aligned(
        torch.empty(1, 8, 9)[:, :, 1:])


def test_build_key_covers_the_shared_header(tmp_path, monkeypatch):
    """The kernels' library is keyed by the sources and the headers they
    include: an edited ``csrc/*.cuh`` never loads a stale build."""
    from raft_tpu_torch.kernels import _build

    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    srcs = _build._sources()
    assert [os.path.basename(x) for x in srcs] == ["a.cu"]
    key = _build._digest(srcs)
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._digest(srcs) != key


@pytest.mark.parametrize("iters", [2, 3])
def test_forward_matches_reference(cfg, weights, port, pair, iters):
    model = ref_gma.GMA(cfg["architecture"]).eval()
    model.load_state_dict(weights)
    want = ref_gma.infer(model, *pair, iters)[0].numpy()
    got = _port_flow(port, pair, iters)
    assert got.shape == want.shape == (124, 250, 2)
    assert check.epe(got, want) < PARITY
    assert float(np.abs(want).max()) > 1.0


@pytest.mark.parametrize("fault", ["to_v_zero"] + list(faults_gma.KINDS))
def test_aggregation_is_live(cfg, weights, pair, fault):
    """Without the aggregation's effect (W_v zeroed; γ = 0; Aᵀ in place of
    A) the flow moves far outside the parity bound."""
    model = RAFT(RAFTConfig(gma_heads=1, **cfg["program"])).eval()
    model.load_state_dict(weights)
    base = _port_flow(model, pair, 3)
    if fault == "to_v_zero":
        with torch.no_grad():
            model.update_block.aggregator.to_v.weight.zero_()
        moved = _port_flow(model, pair, 3)
    else:
        with faults_gma.planted(fault):
            moved = _port_flow(model, pair, 3)
    assert check.epe(moved, base) > 1000 * PARITY


def test_published_state_dict_loads_strictly(cfg, weights, tmp_path):
    """A GMA checkpoint's keys, as the published training script saves
    them (``module.`` prefixes from ``nn.DataParallel``), load into the
    port with ``strict=True``; so does one without the derived
    ``rel_ind`` buffer."""
    names = set(weights)
    for key in ("att.to_qk.weight", "att.pos_emb.rel_height.weight",
                "att.pos_emb.rel_width.weight", "att.pos_emb.rel_ind",
                "update_block.aggregator.to_v.weight",
                "update_block.aggregator.gamma"):
        assert key in names
    assert tuple(weights["update_block.gru.convz1.weight"].shape) == (
        128, 512, 1, 5)
    assert tuple(weights["att.pos_emb.rel_height.weight"].shape) == (319, 128)
    path = tmp_path / "gma-things.pth"
    torch.save({"module." + k: v for k, v in weights.items()}, path)
    model = load_pth(str(path), RAFTConfig(gma_heads=1, **cfg["program"]))
    for key, value in weights.items():
        assert torch.equal(model.state_dict()[key], value), key
    partial = {k: v for k, v in weights.items() if not k.endswith("rel_ind")}
    RAFT(RAFTConfig(gma_heads=1)).load_state_dict(partial, strict=True)
    with pytest.raises(RuntimeError):
        RAFT(RAFTConfig()).load_state_dict(weights, strict=True)


def test_refusals(cfg, port):
    with pytest.raises(ValueError, match="small"):
        RAFTConfig(small=True, gma_heads=1)
    for bad in (2, True, -1, 1.0):
        with pytest.raises(ValueError, match="gma_heads"):
            RAFTConfig(gma_heads=bad)
    x = torch.zeros(1, 64, 64, 3)
    with pytest.raises(ValueError, match="ragged"):
        port.forward_ragged(x, x, torch.full((1,), 8, dtype=torch.int32),
                            torch.full((1,), 8, dtype=torch.int32), iters=1)
    with pytest.raises(ValueError, match="feature-cache"):
        port.forward_cached(x, torch.zeros(1, 8, 8, 256),
                            torch.zeros(1, 8, 8, 256), torch.zeros(1, 8, 8, 2),
                            iters=1)
    banded = copy.deepcopy(port)
    set_spatial(banded, Spatial(None, 0, 2))
    with pytest.raises(ValueError, match="spatial"):
        banded(x, x, iters=1)
    tc = TrainConfig(batch_size=1, image_size=(64, 64), iters=1)
    with pytest.raises(ValueError, match="training GMA"):
        create_train_state(RAFT(RAFTConfig(gma_heads=1)), tc)
    with pytest.raises(ValueError, match="training GMA"):
        make_train_step(RAFTConfig(gma_heads=1), tc)


def test_engine_and_scheduler_serve_gma(cfg, weights):
    """GMA through ``RAFTEngine`` and ``MicroBatchScheduler``, the entry
    points RAFT takes: a served pair's flow is the direct forward's."""
    config = RAFTConfig(gma_heads=1, **cfg["program"])
    engine = RAFTEngine(weights, config=config, iters=2,
                        envelope=[(1, 64, 96), (2, 64, 96)], wire="u8",
                        device="cpu")
    rng = np.random.default_rng(0)
    pairs = [tuple(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
                   for _ in range(2)) for _ in range(3)]
    sched = MicroBatchScheduler(engine, max_batch=2, max_queue=8)
    try:
        futs = [sched.submit(a, b) for a, b in pairs]
        flows = [f.result(timeout=120).flow for f in futs]
    finally:
        sched.close(drain=True)
    model = RAFT(config).eval()
    model.load_state_dict(weights)
    for (a, b), flow in zip(pairs, flows):
        with torch.no_grad():
            _, up = model(torch.from_numpy(a)[None].float(),
                          torch.from_numpy(b)[None].float(), iters=2)
        assert check.epe(flow, up[0].numpy()) < PARITY


def test_program_store_keys_tell_gma_from_raft(cfg, weights, tmp_path):
    """The store's key of a GMA bucket and of a RAFT bucket differ in the
    configuration's component (and the weights'), so a store never hands
    one's program to the other."""
    assert (aot.config_fingerprint(RAFTConfig(**cfg["program"]), 20)
            != aot.config_fingerprint(
                RAFTConfig(gma_heads=1, **cfg["program"]), 20))
    keys = {}
    for name, config, w in (
            ("raft", RAFTConfig(**cfg["program"]),
             RAFT(RAFTConfig(**cfg["program"])).state_dict()),
            ("gma", RAFTConfig(gma_heads=1, **cfg["program"]), weights)):
        engine = RAFTEngine(w, config=config, iters=2, precompile=False,
                            envelope=[(1, 64, 96)], aot_cache=str(tmp_path),
                            device="cpu")
        keys[name] = engine._aot_key((1, 64, 96))
    assert keys["raft"]["config"] != keys["gma"]["config"]
    assert keys["raft"]["weights"] != keys["gma"]["weights"]
    same = {k for k in keys["raft"] if keys["raft"][k] == keys["gma"][k]}
    assert "geometry" in same and "program" in same


def test_gma_flops_and_kernel_costs():
    """11.86 TFLOP a 1088x1920 pair at iters 20 (RAFT basic's 5.47 and
    GMA's 6.39: 20 aggregations of 2·N²·128 at N = 32,640 are 5.45), and
    K6/K7's bytes at that grid."""
    arch = _config()["architecture"]
    total = counts_gma.gma_forward_flops(arch, (1088, 1920), 20)
    raft = serve.counts.forward_flops(arch, (1088, 1920), 20)
    assert total / 1e12 == pytest.approx(11.86, abs=0.005)
    assert raft / 1e12 == pytest.approx(5.47, abs=0.005)
    n = 136 * 240
    k6, k7 = counts_gma.attention_cost(n), counts_gma.aggregate_cost(n)
    assert k6[0] == 2 * n * 128 * 4 + n * n * 4 and k6[1] == 2 * n * n * 128
    assert k7[0] == n * n * 4 + 3 * n * 128 * 4 and k7[1] == k6[1]
    assert 20 * k7[1] / 1e12 == pytest.approx(5.45, abs=0.005)
    # bytes bound both at the TF32 rate: 1.28 and 1.29 ms a launch
    assert counts_gma.least_s(k6) * 1e3 == pytest.approx(1.282, abs=0.001)
    assert counts_gma.least_s(k7) * 1e3 == pytest.approx(1.287, abs=0.001)
    bounds = counts_gma.launch_bounds({(2, 1088, 1920): 3}, 20)
    assert bounds["k6"] == [(3, counts_gma.least_s((2 * k6[0],
                                                    2 * k6[1])))]
    assert bounds["k7"][0][0] == 60


def test_readers_find_the_gma_kernels_by_name():
    ctx = {"events": [("gma_attention_kernel", 0.0, 0.002),
                      ("gma_aggregate_kernel", 0.002, 0.005),
                      ("gma_aggregate_kernel", 0.005, 0.008),
                      ("corr_lookup_kernel", 0.008, 0.010)],
           "busy_s": 0.010,
           "gma_launch_bounds": {"k6": [(1, 0.001)], "k7": [(2, 0.0015)]}}
    assert counts_gma.share(ctx) == pytest.approx(80.0)
    assert counts_gma.roofline(ctx, "k6") == pytest.approx(50.0)
    assert counts_gma.roofline(ctx, "k7") == pytest.approx(50.0)
    # a parent's trace holds no GMA kernel: the readers read nothing
    bare = dict(ctx, events=ctx["events"][3:])
    assert counts_gma.share(bare) is None
    assert counts_gma.roofline(bare, "k7") is None


_LOAD_REFERENCE = r"""
import json, sys
import flowbench.reference.gma
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_reference_loads_nothing_of_the_program():
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", _LOAD_REFERENCE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "flowbench" in mods and "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "raft_tpu", "raft_tpu_torch"}


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """The benchmark's data files under a checkout-shaped directory, the
    GMA cell cut to a CPU test's size: 128x256 frames, two clients, iters
    2, a pool of 8 and a sample of 4."""
    dst = tmp_path / "checkout"
    os.makedirs(dst / "flowbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    for d in ("configs", "metrics", "limits", "traffic"):
        shutil.copytree(os.path.join(ROOT, "flowbench", d),
                        dst / "flowbench" / d)
    path = dst / "flowbench" / "configs" / "gma.json"
    gma = json.loads(path.read_text())
    gma["serve"]["iters"] = 2
    path.write_text(json.dumps(gma))
    path = dst / "flowbench" / "traffic" / "hd1080-serve-c8.json"
    mix = json.loads(path.read_text())
    mix.update(frames=[128, 256], clients=2)
    path.write_text(json.dumps(mix))
    for name, value in (("POOL", 8), ("SAMPLE", 4), ("TRACE_SECONDS", 1)):
        monkeypatch.setattr(serve, name, value)
    return str(dst)


def test_witness_rounds_to_tf32():
    """The witness's convolution operands: float32 with a 10-bit mantissa,
    to nearest, ties away from zero, in any layout."""
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -12, -1 - 3 * 2 ** -12,
                      1 + 2 ** -12, 3.14159265, 0.0])
    want = [1.0, 1 + 2 ** -10, 1 + 2 ** -10, -1 - 2 ** -10, 1.0, 3.140625,
            0.0]
    assert serve_gma.tf32(x).tolist() == want
    y = torch.randn(2, 8, 4, 5).contiguous(memory_format=torch.channels_last)
    rel = (serve_gma.tf32(y) - y).abs() / y.abs()
    assert float(rel.max()) <= 2 ** -11 and float(rel.max()) > 2 ** -13


def test_cell_runs_correct_at_a_cpu_size(tiny_root):
    out = run.measure(Cell(CELL, tiny_root), SEED, 2, False,
                      torch.device("cpu"))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"pairs_per_s", "setup_s"}


def test_cell_traced_context_counts_gma(tiny_root):
    out = run.measure(Cell(CELL, tiny_root), SEED, 2, True,
                      torch.device("cpu"))
    ctx = out["ctx"]
    assert ctx["flops_per_pair"] == counts_gma.gma_forward_flops(
        _config()["architecture"], (128, 256), 2)
    assert set(ctx["gma_launch_bounds"]) == {"k6", "k7"}
    # the CPU has no device trace: no device metric reads
    assert out["metrics"] == {}


@pytest.mark.parametrize("fault", faults_gma.KINDS)
def test_cell_catches_each_fault(tiny_root, fault):
    with faults_gma.planted(fault):
        out = run.measure(Cell(CELL, tiny_root), SEED, 2, False,
                          torch.device("cpu"))
    assert not out["correct"], out["checks"]
