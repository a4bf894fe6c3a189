"""The port's measuring CLIs on the CPU, at tiny sizes: their plumbing, and
``corr_bench``'s routes against each other and against the JAX package's
``gather`` lookup on the same inputs.

On CPU tensors the kernel routes (``pallas``, ``alt_pallas``) run their
plain versions, so on the CPU they agree with the plain routes bitwise in
the forward; the card holds the kernels themselves (``chip_smoke.py``,
``tests/test_torch_kernels_gpu.py``). Times of a CPU run are the CPU's and
are labelled with the device ``"cpu"``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.models.corr import build_corr_pyramid as jax_pyramid
from raft_tpu.models.corr import corr_lookup as jax_corr_lookup
from raft_tpu_torch.cli import (corr_bench, envelope, infer_bench,
                                loader_bench, profile_step, trace_summary)
from raft_tpu_torch.config import RAFTConfig, stage_config
from raft_tpu_torch.training.trainer import train

ARGS = ["--device", "cpu", "--batch", "1", "--hw", "8", "12", "--dim", "16",
        "--radius", "2", "--levels", "2", "--iters", "2"]


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _json_line(capsys):
    out = capsys.readouterr().out
    return out, json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("grad", [False, True])
def test_corr_bench_routes_agree(grad, capsys):
    argv = ARGS + (["--grad"] if grad else [])
    rows, failed = corr_bench.main(argv)
    assert not failed and set(rows) == set(corr_bench.ROUTES)
    out, line = _json_line(capsys)
    assert line["routes"] == rows
    assert line["device"] == "cpu" and line["grad"] is grad
    assert rows["pallas"]["reference"] == "gather"
    assert rows["alt_pallas"]["reference"] == "alt"
    assert rows["grid_sample"]["reference"] == "gather"
    for name, row in rows.items():
        assert row["max_abs_diff"] < 1e-5, (name, out)
        assert row.get("primal_rel_diff", 0.0) < 1e-6, (name, out)
        assert row["ms"] > 0


def test_corr_bench_routes_match_the_jax_gather():
    """The same numpy inputs through JAX's pyramid and gather lookup and
    through each of the port's routes: within 1e-5 (the JAX lookup rounds
    each tap's fraction on its own, the port's once a query)."""
    f1, f2, coords = corr_bench.make_inputs(2, (8, 12), 16, seed=3)
    want = np.asarray(jax_corr_lookup(
        jax_pyramid(jnp.asarray(f1), jnp.asarray(f2), 3),
        jnp.asarray(coords), 2))
    routes = corr_bench.lookup_routes(torch.from_numpy(f1),
                                      torch.from_numpy(f2), 3, 2)
    c = torch.from_numpy(coords)
    for name, (inputs, fn, _) in routes.items():
        got = fn(inputs, c).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)


def test_corr_bench_catches_a_broken_backward(monkeypatch, capsys):
    """A scatter that returned zeros must show as a large gradient gap of
    the kernel route against the plain one."""
    from raft_tpu_torch.kernels import corr_lookup as kcl

    monkeypatch.setattr(kcl, "corr_scatter_cuda",
                        lambda grad, pyramid, coords, radius:
                        [torch.zeros_like(v) for v in pyramid])
    corr_bench.main(ARGS + ["--grad", "--impls", "gather", "pallas"])
    _, line = _json_line(capsys)
    assert line["routes"]["pallas"]["max_abs_diff"] > 0.1


def test_corr_bench_reports_missing_routes(capsys):
    """The JAX package's XLA-only formulations, and any unknown name, are
    failed routes; the others still run."""
    rows, failed = corr_bench.main(
        ARGS + ["--impls", "gather", "onehot", "softsel", "onehot_t",
                "onehott"])
    assert failed == ["onehot", "softsel", "onehot_t", "onehott"]
    assert set(rows) == {"gather"}
    out, line = _json_line(capsys)
    assert "no counterpart in the port" in out and "unknown route" in out
    assert line["failed"] == failed


def _kernel_event(name, dur, cat="kernel", ts=0):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur}


def test_trace_summary_rolls_up_a_crafted_trace(tmp_path, capsys):
    events = [
        _kernel_event("void corr_lookup_kernel(Levels, float const*)", 40),
        _kernel_event("void corr_lookup_kernel(Levels, float const*)", 45),
        _kernel_event("void corr_scatter_kernel(LevelsOut)", 200),
        _kernel_event("void gru_gates_kernel<float>(float const*)", 11),
        _kernel_event("void gru_gates_bwd_kernel<__nv_bfloat16>(x)", 30),
        _kernel_event("void gru_blend_kernel<float>(float const*)", 8),
        _kernel_event("void gru_blend_bwd_kernel<float>(float const*)", 9),
        _kernel_event("void corr_alt_kernel<4>(AltLevels const)", 120),
        _kernel_event("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32", 500),
        _kernel_event("void fft2d_r2c_32x32<float>(float2*)", 70),
        _kernel_event("sm80_xmma_gemm_cf32cf32_cf32f32_f32_nt_n", 300),
        _kernel_event("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize", 90),
        _kernel_event("void at::native::vectorized_elementwise_kernel<4, "
                      "at::native::AddFunctor<float>>(int)", 25),
        _kernel_event("void at::native::unrolled_elementwise_kernel<"
                      "at::native::direct_copy_kernel_cuda>(int)", 12),
        _kernel_event("void at::native::elementwise_kernel<128, 4, "
                      "at::native::gpu_kernel_impl_nocast<at::native::"
                      "CUDAFunctor_add<float>>>(int)", 6),
        _kernel_event("void cudnn::bn_bw_1C11_kernel_new<float, float>(x)",
                      4),
        _kernel_event("void cudnn::engines_precompiled::nchwToNhwcKernel"
                      "<float>(x)", 16),
        _kernel_event("Memcpy HtoD (Pageable -> Device)", 50, "gpu_memcpy"),
        _kernel_event("Memset (Device)", 2, "gpu_memset"),
        _kernel_event("some_custom_thing", 5),
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0,
         "dur": 999},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
    ]
    path = tmp_path / "host.123.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    summary = trace_summary.main([str(tmp_path), "--top", "3"])
    cats = summary["categories"]
    assert summary["events"] == 20 and summary["device_us"] == 1543
    assert cats["K1 corr_lookup"] == {"us": 85.0, "count": 2,
                                      "share": 85.0 / 1543}
    for label, us in (("K3 corr_scatter", 200), ("K2 gru_gates", 11),
                      ("K2 gru_blend", 8), ("K4 gru_gates_bwd", 30),
                      ("K4 gru_blend_bwd", 9), ("K5 corr_alt", 120),
                      ("convolutions", 870), ("gemms", 90),
                      ("elementwise and reductions", 35),
                      ("copies and casts", 80), ("other", 5)):
        assert cats[label]["us"] == us, label
    assert [op["us"] for op in summary["top"]] == [500, 300, 200]
    out, line = _json_line(capsys)
    assert "device time by category" in out and line["events"] == 20


def test_trace_summary_of_a_cpu_trace_is_empty(tmp_path, capsys):
    """The trainer's ``profile_steps`` trace on the CPU has no device
    events: the summary reports empty."""
    rng = np.random.RandomState(0)
    im = rng.randint(0, 256, (1, 32, 32, 3)).astype(np.uint8)
    batch = {"image1": im, "image2": im,
             "flow": np.zeros((1, 32, 32, 2), np.float32),
             "valid": np.ones((1, 32, 32), np.uint8)}
    tc = stage_config("chairs", name="prof", batch_size=1,
                      image_size=(32, 32), iters=1, num_steps=2,
                      validation=(), profile_steps=(1, 2),
                      checkpoint_dir=str(tmp_path / "ckpt"),
                      log_dir=str(tmp_path / "runs"))
    train(RAFTConfig(small=True), tc, loader=[batch], device="cpu")
    capsys.readouterr()
    summary = trace_summary.main([str(tmp_path / "runs" / "prof")])
    assert summary["events"] == 0 and summary["categories"] == {}
    assert summary["files"] and summary["top"] == []
    out, _ = _json_line(capsys)
    assert "no device events" in out


def test_loader_bench_plumbing(capsys):
    out = loader_bench.main(["--samples", "4", "--batch", "2", "--epochs",
                             "1", "--workers", "1",
                             "--step-pairs-per-sec", "1e6"])
    assert out["pairs"] == 4 and out["pairs_per_s"] > 0
    assert out["workers"] == 1 and out["binding"] is True
    assert out["ratio"] == pytest.approx(out["pairs_per_s"] / 1e6)
    _, line = _json_line(capsys)
    assert line["metric"] == "loader_pairs_per_s"


@pytest.mark.parametrize("extra", [["--fp32"], ["--remat"]],
                         ids=["fp32", "bf16-remat"])
def test_profile_step_plumbing(extra, tmp_path, capsys):
    out = profile_step.main(
        ["--device", "cpu", "--batch", "1", "--hw", "64", "64", "--iters",
         "1", "--steps", "2", "--warmup", "1", "--top", "5",
         "--trace-dir", str(tmp_path)] + extra)
    assert out["device"] == "cpu" and out["bf16"] is ("--fp32" not in extra)
    assert out["remat"] is ("--remat" in extra)
    assert len(out["ms_steps"]) == 2 and out["ms_per_step"] > 0
    # no device on the CPU: no busy time, idle share or peak is claimed
    assert out["device_busy_ms"] is None and out["idle_share"] is None
    assert out["peak_mib"] is None and len(out["top_ops"]) == 5
    assert os.path.exists(out["trace"])
    assert out["trace"].endswith(".pt.trace.json")
    _, line = _json_line(capsys)
    assert line["metric"] == "profile_step"
    assert trace_summary.main([str(tmp_path)])["events"] == 0


@pytest.mark.parametrize("extra", [[], ["--alternate_corr"],
                                   ["--corr_impl", "gather"]])
def test_infer_bench_plumbing(extra, capsys):
    out = infer_bench.main(["--device", "cpu", "--small", "--hw", "64", "64",
                            "--iters", "2", "--reps", "1"] + extra)
    assert out["device"] == "cpu" and out["hw"] == [64, 64]
    assert out["alternate_corr"] is ("--alternate_corr" in extra)
    assert out["ms_per_pair"] > 0 and out["pairs_per_s"] > 0
    # kernels launch only on the card
    assert out["launches_per_forward"] == {} and out["peak_mib"] is None
    _, line = _json_line(capsys)
    assert line["metric"] == "raft_small_infer_64x64_b1_iters2"


def test_measuring_clis_need_the_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        envelope.main(["--n", "64"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer_bench.main(["--small", "--hw", "64", "64"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        corr_bench.main(["--hw", "8", "12"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_step.main(["--hw", "64", "64"])


@pytest.mark.parametrize("flags,policy,fused", [
    (["--remat", "--remat_policy", "full", "--fused_loss"], "full", True),
    (["--remat", "--remat-policy", "dots", "--no-fused-loss"], "dots", False),
    ([], "full", None)], ids=["full-fused", "dots-standard", "defaults"])
def test_profile_step_remat_policy_and_fused_loss(flags, policy, fused,
                                                  monkeypatch, capsys):
    """``--remat_policy`` and ``--fused_loss`` reach the configs the train
    step is built from, as in the JAX CLI, and the JSON line records both."""
    from raft_tpu_torch.training import train_step

    seen = []
    real = train_step.make_train_step

    def spy(model_cfg, train_cfg, *a, **kw):
        seen.append((model_cfg, train_cfg))
        return real(model_cfg, train_cfg, *a, **kw)

    monkeypatch.setattr(train_step, "make_train_step", spy)
    out = profile_step.main(
        ["--device", "cpu", "--batch", "1", "--hw", "32", "32", "--iters",
         "1", "--steps", "1", "--warmup", "1", "--top", "3"] + flags)
    (model_cfg, train_cfg), = seen
    assert model_cfg.remat_policy == policy and train_cfg.fused_loss is fused
    assert model_cfg.remat is ("--remat" in flags) and not model_cfg.small
    assert out["remat_policy"] == policy and out["fused_loss"] is fused
    _, line = _json_line(capsys)
    assert line["remat_policy"] == policy and line["fused_loss"] is fused


def test_profile_step_fused_loss_with_small_raises():
    """The small model has no fused loss (``training/train_step.py``):
    asking the profiler to trace it raises instead of tracing the standard
    loss; ``--small`` alone profiles the small model."""
    with pytest.raises(ValueError, match="no fused loss"):
        profile_step.main(["--device", "cpu", "--small", "--fused_loss"])
    out = profile_step.main(
        ["--device", "cpu", "--small", "--batch", "1", "--hw", "32", "32",
         "--iters", "1", "--steps", "1", "--warmup", "1", "--top", "3"])
    assert out["small"] is True and out["fused_loss"] is None
