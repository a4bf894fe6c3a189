"""The port's serving front end against ``raft_tpu``'s on the CPU, with the
small trained fixture (``.msgpack`` into JAX, ``.pth`` into the port):

- the same seeded pairs served by a JAX scheduler over a JAX engine and by
  the port's scheduler over a CPU port engine, each future's flow within
  5e-4 px (the ROADMAP's end-to-end bound);
- ``VideoSession`` with the host warm start, with the device-resident
  state, and with the feature cache, pair by pair within 5e-4 px;
- ``forward_interpolate_device`` equal to JAX's on tie-free fields, holes
  and NaN input, and its fixed winner on ties;
- ``cli/serve_bench``: the summary's keys equal JAX's ``run_drill`` keys
  for the same flags; one ``--chaos 1`` round strands nothing and keeps
  the accounting identity; the spans file the port writes is read by both
  packages' ``serve_trace`` alike, and every record passes both packages'
  validators.
"""

import json
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.serving.engine import RAFTEngine as JaxEngine
from raft_tpu.serving.scheduler import MicroBatchScheduler as JaxScheduler
from raft_tpu.serving.session import VideoSession as JaxSession
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.ops.interp import forward_interpolate_device
from raft_tpu_torch.serving import (MicroBatchScheduler, RAFTEngine,
                                    VideoSession)
from raft_tpu_torch.tools.convert import load_pth

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(REPO, "tests", "fixtures", "raft-small-cputrained")
TOL = 5e-4
WAIT = 120.0
ITERS = 2
SHAPES = [(32, 32), (24, 40)]


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    with open(FIXTURE + ".msgpack", "rb") as fh:
        variables = serialization.msgpack_restore(fh.read())
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    return variables, load_pth(FIXTURE + ".pth", RAFTConfig(small=True))


def _frames(seed, n, h=32, w=48):
    """``n`` integer-valued frames of a random texture, each moved (1, 2)
    px from the last: a flow the trained fixture tracks."""
    rng = np.random.RandomState(seed)
    base = np.floor(rng.rand(h + 2 * n, w + 2 * n, 3) * 256).astype(
        np.float32)
    return [base[k:k + h, 2 * k:2 * k + w] for k in range(n)]


def _pairs(seed, n):
    out = []
    for k in range(n):
        h, w = SHAPES[k % len(SHAPES)]
        f = _frames(seed + k, 2, h, w)
        out.append((f[0], f[1]))
    return out


def _engines(weights, envelope, **kw):
    variables, model = weights
    return (JaxEngine(variables, JaxConfig(small=True), iters=ITERS,
                      envelope=envelope, precompile=True, **kw),
            RAFTEngine(model, model.config, iters=ITERS, envelope=envelope,
                       device="cpu", **kw))


def _gap(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


# -- the scheduler -----------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2])
def test_scheduler_flows_match_jax(weights, depth):
    envelope = [(2, h, w) for h, w in SHAPES]
    jeng, teng = _engines(weights, envelope, warm_start=True)
    pairs = _pairs(3, 6)
    flows = []
    for cls, eng in ((JaxScheduler, jeng), (MicroBatchScheduler, teng)):
        with cls(eng, max_batch=2, gather_window_s=0.0,
                 pipeline_depth=depth) as sched:
            futs = [sched.submit(a, b, want_low=True) for a, b in pairs]
            flows.append([f.result(timeout=WAIT) for f in futs])
        snap = sched.metrics.snapshot()
        assert snap["completed"] == 6 and snap["abandoned_inflight"] == 0
    for (h, w), j, t in zip([p[0].shape[:2] for p in pairs], *flows):
        assert t.flow.shape == (h, w, 2) and isinstance(t.flow, np.ndarray)
        assert _gap(j.flow, t.flow) <= TOL
        assert _gap(j.flow_low, t.flow_low) <= TOL
    assert teng.executable_count() == 2     # no bucket beyond the envelope


# -- video sessions ----------------------------------------------------------

@pytest.mark.parametrize("device_state", [False, True])
def test_video_session_matches_jax(weights, device_state):
    jeng, teng = _engines(weights, [(1, 32, 48)], warm_start=True)
    frames = _frames(11, 5)
    results, warm = [], []
    for cls, scls, eng in ((JaxScheduler, JaxSession, jeng),
                           (MicroBatchScheduler, VideoSession, teng)):
        with cls(eng, max_batch=1, gather_window_s=0.0) as sched:
            sess = scls(sched, device_state=device_state)
            futs = [sess.submit_frame(f) for f in frames]
            results.append([f.result(timeout=WAIT) for f in futs[1:]])
            warm.append(sess.warm_submits)
            final = sess.drain()
        assert isinstance(final, np.ndarray) and final.shape == (4, 6, 2)
    assert warm[0] == warm[1] == len(frames) - 2
    if device_state:
        # the recurrence state stayed a tensor between pairs
        assert all(isinstance(r.flow_low, torch.Tensor) for r in results[1])
    for j, t in zip(*results):
        assert _gap(j.flow, t.flow) <= TOL


def test_feature_cache_session_matches_jax(weights):
    jeng, teng = _engines(weights, [(1, 32, 48)], warm_start=True,
                          feature_cache=True)
    frames = _frames(12, 5)
    results, stats = [], []
    for cls, scls, eng in ((JaxScheduler, JaxSession, jeng),
                           (MicroBatchScheduler, VideoSession, teng)):
        with cls(eng, max_batch=1, gather_window_s=0.0,
                 feature_cache=True) as sched:
            sess = scls(sched, feature_cache=True)
            futs = [sess.submit_frame(f) for f in frames]
            assert futs[0] is None
            results.append([f.result(timeout=WAIT) for f in futs[1:]])
            assert sess.drain() is None
            stats.append((sess.warm_submits,
                          sched.metrics.snapshot()["feature_cache"]["hits"]))
    assert stats[0] == stats[1] == (4, 4)
    for j, t in zip(*results):
        assert _gap(j.flow, t.flow) <= TOL


# -- the device forward warp -------------------------------------------------

def _jax_warp(flow):
    from raft_tpu.ops.interp import forward_interpolate_device as jwarp
    return np.asarray(jwarp(jnp.asarray(flow)))


@pytest.mark.parametrize("case", ["shift", "jitter", "holes", "nan", "out"])
def test_forward_interpolate_device_matches_jax(case):
    rng = np.random.RandomState(5)
    flow = np.zeros((9, 12, 2), np.float32)
    flow[..., 0], flow[..., 1] = 1.0, 1.0
    if case == "jitter":     # per-pixel motion, still one source a cell
        flow += rng.uniform(-0.4, 0.4, flow.shape).astype(np.float32)
    if case == "holes":      # the right half moves 2 px: vacated cells
        flow[:, 6:, 0] = 2.0
    if case == "nan":
        flow[3:5, 2:7] = np.nan
    if case == "out":        # points leaving the frame are dropped
        flow[:, :4, 0] = -5.0
    got = forward_interpolate_device(torch.from_numpy(flow)).numpy()
    np.testing.assert_array_equal(got, _jax_warp(flow))
    assert np.isfinite(got).all()
    if case == "shift":
        assert (got[0] == 0).all() and (got[:, 0] == 0).all()
        assert (got[1:, 1:] == 1).all()


def test_forward_interpolate_device_fixed_winner_on_ties():
    """Two sources landing on one cell: the larger row-major index wins,
    deterministically (the CUDA-safe policy the docstring states)."""
    flow = np.zeros((4, 5, 2), np.float32)
    flow[1, 1] = (1.0, 0.0)       # (1, 1) -> (1, 2), index 6
    flow[1, 2] = (0.25, 0.0)      # (1, 2) -> (1, 2), index 7: wins
    got = forward_interpolate_device(torch.from_numpy(flow)).numpy()
    np.testing.assert_array_equal(got[1, 2], (0.25, 0.0))
    assert (got[1, 1] == 0).all()     # its own source moved away
    again = forward_interpolate_device(torch.from_numpy(flow)).numpy()
    np.testing.assert_array_equal(got, again)


def test_nan_flow_init_on_the_device_degrades_to_cold(weights):
    _, teng = _engines(weights, [(1, 32, 48)], warm_start=True)
    a, b = _frames(13, 2)
    with MicroBatchScheduler(teng, gather_window_s=0.0) as sched:
        cold = sched.submit(a, b).result(timeout=WAIT).flow
        init = forward_interpolate_device(torch.full((4, 6, 2), np.nan))
        warm = sched.submit(a, b, flow_init=init).result(timeout=WAIT).flow
        with pytest.raises(ValueError, match="non-finite"):
            sched.submit(a, b, flow_init=np.full((4, 6, 2), np.nan,
                                                 np.float32))
        with pytest.raises(ValueError, match="1/8 of the"):
            sched.submit(a, b, flow_init=torch.zeros(5, 6, 2))
    np.testing.assert_array_equal(cold, warm)


# -- the CLIs ----------------------------------------------------------------

def _keys(d):
    """A summary's nested key set."""
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    return None


def test_serve_bench_summary_keys_match_jax(weights, tmp_path, capsys):
    from raft_tpu.cli import serve_bench as jbench
    from raft_tpu.cli.serve_trace import load_spans as jload
    from raft_tpu.cli.serve_trace import main as jtrace_main
    from raft_tpu.serving import schema as jschema
    from raft_tpu_torch.cli import serve_bench, serve_trace
    from raft_tpu_torch.serving import schema

    variables, model = weights
    common = dict(shapes=SHAPES, requests=6, submitters=2, bucket_batch=2,
                  iters=1, sessions=1, session_frames=3, seed=4,
                  gather_window_s=0.0)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    js = jbench.run_drill(variables, JaxConfig(small=True),
                          trace_path=str(tmp_path / "jax" / "spans.jsonl"),
                          metrics_path=str(tmp_path / "jax" / "m.jsonl"),
                          **common)
    spans = str(tmp_path / "port" / "spans.jsonl")
    ts = serve_bench.run_drill(model, model.config, trace_path=spans,
                               metrics_path=str(tmp_path / "port" / "m.jsonl"),
                               device="cpu", **common)
    assert _keys(ts) == _keys(js)
    assert ts["accounting_ok"] and ts["stranded"] == 0
    assert ts["served"] == 6 and ts["session_pairs"] == 3
    assert ts["tail_exemplars"]["ledger"]["open"] == 0
    # the port's spans and metrics through both packages' validators and
    # both packages' readers
    for path in (spans, str(tmp_path / "port" / "m.jsonl")):
        with open(path) as fh:
            recs = [json.loads(line) for line in fh]
        assert recs
        assert schema.validate_lines(recs) == []
        assert jschema.validate_lines(recs) == []
    assert serve_trace.load_spans(spans) == jload(spans)
    capsys.readouterr()
    for argv in ([spans], [spans, "--all", "--top", "3"],
                 [spans, "--trace", "r-1"]):
        reports = []
        for reader in (serve_trace.main, jtrace_main):
            reader(argv)
            reports.append(capsys.readouterr().out)
        assert reports[0] == reports[1] and reports[0].strip()


def test_serve_bench_cli_cpu_chaos_round(tmp_path, capsys):
    from raft_tpu_torch.cli import serve_bench

    serve_bench.main(["--device", "cpu", "--small", "--shapes",
                      "32x32,24x40", "--requests", "6", "--iters", "1",
                      "--bucket-batch", "2", "--chaos", "1", "--seed", "2",
                      "--log-dir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["violations"] == [] and out["chaos_rounds"] == 1
    for rnd in out["per_round"]:
        assert rnd["stranded"] == 0 and rnd["accounting_ok"]
        assert rnd["abandoned_inflight"] == 0
    assert out["executables"] == out["documented_buckets"] == 2


@pytest.mark.parametrize("flag", [["--hosts", "1", "--models", "small"],
                                  ["--hosts-kill-one"],
                                  ["--aot-cache", "d", "--models", "small"],
                                  ["--guardian"],
                                  ["--replicas", "2", "--models", "small"],
                                  ["--models", "small", "--ragged"]])
def test_serve_bench_fleet_and_registry_flags_name_m11b(flag):
    """The registry, fleet, host and program-store flags drive their
    drills (M11b, M11c); combinations the drills do not take exit saying
    why, before anything is built."""
    from raft_tpu_torch.cli import serve_bench

    match = {"--guardian": "need --models", "--replicas": "plain drill",
             "--models": "single-model drill",
             "--hosts": "single-model drills only",
             "--hosts-kill-one": "needs --hosts",
             "--aot-cache": "not wired yet"}[flag[0]]
    with pytest.raises(SystemExit, match=match):
        serve_bench.main(["--device", "cpu", *flag])
