"""Supervised training of the port on the CPU: the fault harness, retry and
backoff, the watchdog, the restore sandbox, the supervisor and the
``--supervise`` CLI, each held to its JAX counterpart where one exists.

- The same plan fires the same sequence of faults in both ``faults``
  modules; the same seed gives the same ``backoff_delays``; the same
  scripted sequence of (exit code, restore point) gives the same restart
  and give-up decisions, events and final exit code from both
  ``Supervisor``s.
- The cases of the JAX package's ``TestSupervisorUnit``,
  ``TestWatchdogPostmortem``, ``TestOrbaxFallback`` (against the port's
  restore sandbox) and ``TestTrainCLISupervise``.
- An end-to-end drill at tier-1 size: ``python -m raft_tpu_torch.cli.train
  --device cpu --small --supervise`` on tiny synthetic chairs with a plan
  that corrupts the second full-state save and hangs the fourth step of
  the first attempt. The watchdog exits 3, the supervisor restarts with
  ``--resume``, the sandbox's read of the corrupt step fails and the step
  is quarantined, the run resumes from the step before it, and the final
  ``.pth`` is bitwise equal to an uninterrupted control run's.
"""

import itertools
import json
import os
import random
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import raft_tpu.testing.faults as jax_faults
import raft_tpu.training.supervisor as jax_supervisor
from raft_tpu.utils.retry import backoff_delays as jax_backoff_delays
from raft_tpu_torch.testing import faults
from raft_tpu_torch.training import checkpoint as ckpt_lib
from raft_tpu_torch.training.restore_sandbox import (ENV_ERROR_EXIT,
                                                     STEP_UNREADABLE_EXIT)
from raft_tpu_torch.training.supervisor import (ATTEMPT_ENV, Supervisor,
                                                describe_exit, exit_class)
from raft_tpu_torch.training.optim import make_optimizer
from raft_tpu_torch.training.train_step import TrainState
from raft_tpu_torch.utils.ckpt_scan import latest_step_on_disk, step_dirs
from raft_tpu_torch.utils.retry import backoff_delays, retry
from raft_tpu_torch.utils.watchdog import WEDGED_EXIT_CODE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "raft_tpu_torch")


@pytest.fixture(autouse=True)
def _disarm_after():
    yield
    faults.disarm()
    jax_faults.disarm()


# ---------------------------------------------------------------------------
# the fault harness
# ---------------------------------------------------------------------------

class TestFaultPlan:
    def test_occurrence_counting_and_one_shot(self):
        faults.arm([{"site": "x", "at": 2, "kind": "raise"}])
        faults.fault_point("x")  # occurrence 1: below threshold
        with pytest.raises(faults.FaultInjected, match="occurrence 2"):
            faults.fault_point("x")
        faults.fault_point("x")  # fired entries never re-fire

    def test_disarmed_is_noop(self):
        faults.disarm()
        faults.fault_point("anything")
        assert not faults.armed("anything")

    def test_arm_from_env_and_dict_form(self, monkeypatch):
        monkeypatch.setenv("RAFT_FAULT_PLAN", json.dumps(
            {"faults": [{"site": "y", "kind": "raise"}]}))
        faults.arm_from_env()
        assert faults.armed("y")
        with pytest.raises(faults.FaultInjected):
            faults.fault_point("y")
        assert not faults.armed("y")

    def test_arm_from_plan_file(self, tmp_path, monkeypatch):
        plan = tmp_path / "plan.json"
        plan.write_text(json.dumps([{"site": "z", "kind": "raise"}]))
        monkeypatch.delenv("RAFT_FAULT_PLAN", raising=False)
        monkeypatch.setenv("RAFT_FAULT_PLAN_FILE", str(plan))
        faults.arm_from_env()
        assert faults.armed("z")

    def test_attempt_scoping(self, monkeypatch):
        plan = [{"site": "a", "kind": "raise", "attempt": 0},
                {"site": "b", "kind": "raise", "attempt": 1}]
        monkeypatch.setenv(ATTEMPT_ENV, "1")
        faults.arm(plan)
        assert not faults.armed("a") and faults.armed("b")
        monkeypatch.delenv(ATTEMPT_ENV)
        faults.arm(plan)  # unset env = attempt 0
        assert faults.armed("a") and not faults.armed("b")

    def test_invalid_entries_rejected(self):
        with pytest.raises(ValueError, match="kind"):
            faults.arm([{"site": "x", "kind": "explode"}])
        with pytest.raises(ValueError, match="1-based"):
            faults.arm([{"site": "x", "kind": "raise", "at": 0}])
        with pytest.raises(ValueError, match="p="):
            faults.arm([{"site": "x", "kind": "raise", "p": 0.0}])
        with pytest.raises(ValueError, match="count="):
            faults.arm([{"site": "x", "kind": "raise", "count": -1}])

    def test_unknown_dotted_site_rejected_with_nearest_hint(self):
        with pytest.raises(ValueError, match=r"trainer\.stp.*did you mean "
                                             r"'trainer\.step'"):
            faults.arm([{"site": "trainer.stp", "kind": "raise"}])
        # the JAX package's AOT-store site comes with the port's store
        # (ROADMAP M11c); the front end's serve.request is armed
        with pytest.raises(ValueError, match="KNOWN_SITES"):
            faults.arm([{"site": "aot.load", "kind": "raise"}])
        faults.arm([{"site": "serve.request", "kind": "raise"}])
        faults.arm([{"site": "x", "kind": "raise"}])
        assert faults.armed("x")

    def test_known_sites_table_matches_armed_reality(self):
        """Every row of KNOWN_SITES is armed somewhere in the port, and
        every site the port arms has a row; each row's site is also a site
        of the JAX package, so one plan drives either package."""
        armed = set()
        call = re.compile(
            r"fault_(?:point|file|data)\(\s*[\"']([\w.]+)[\"']")
        site_kw = re.compile(r"site=[\"']([\w.]+)[\"']")
        for root, _, files in os.walk(PKG):
            for f in files:
                if f.endswith(".py") and f != "faults.py":
                    text = open(os.path.join(root, f)).read()
                    armed |= set(call.findall(text))
                    armed |= set(site_kw.findall(text))
        assert armed == set(faults.KNOWN_SITES)
        assert set(faults.KNOWN_SITES) <= set(jax_faults.KNOWN_SITES)
        for site, desc in faults.KNOWN_SITES.items():
            assert "." in site and isinstance(desc, str) and desc, site
        faults.arm([{"site": s, "kind": "raise", "at": 10 ** 9}
                    for s in faults.KNOWN_SITES])

    def test_fault_file_zeroes_content(self, tmp_path):
        p = tmp_path / "blob"
        p.write_bytes(b"A" * 300)
        faults.arm([{"site": "f", "kind": "corrupt"}])
        assert faults.fault_file("f", str(p)) == str(p)
        assert p.read_bytes() == b"\x00" * 300
        d = tmp_path / "step"
        d.mkdir()
        (d / "small").write_bytes(b"s" * 10)
        (d / "big").write_bytes(b"B" * 400)
        faults.arm([{"site": "f", "kind": "corrupt"}])
        assert faults.fault_file("f", str(d)) == str(d / "big")
        assert (d / "small").read_bytes() == b"s" * 10
        faults.arm([{"site": "f", "kind": "corrupt"}])
        assert faults.fault_data("f", b"abc") == b"\x00" * 3
        assert faults.fault_data("f", b"abc") == b"abc"  # fired once


PLANS = [
    [{"site": "x", "at": 2, "kind": "raise"},
     {"site": "y", "at": 1, "count": 3, "kind": "raise"}],
    {"seed": 7, "faults": [{"site": "x", "p": 0.4, "count": 0,
                            "kind": "raise"},
                           {"site": "trainer.step", "at": 3, "count": 2,
                            "p": 0.7, "kind": "raise"}]},
    [{"site": "ckpt.orbax_save", "kind": "corrupt", "at": 2},
     {"site": "ckpt.orbax_save", "kind": "raise", "at": 3},
     {"site": "loader.sample", "kind": "raise", "p": 0.5, "count": 4,
      "attempt": 1}],
]


def _fire_sequence(mod, plan, tmp_path, attempt, monkeypatch):
    """Which calls of a fixed sequence fired under ``plan`` in ``mod``."""
    monkeypatch.setenv(ATTEMPT_ENV, str(attempt))
    mod.arm(json.loads(json.dumps(plan)))
    out = []
    blob = tmp_path / f"{mod.__name__}.blob"
    for i in range(40):
        site = ("x", "y", "trainer.step", "loader.sample",
                "ckpt.orbax_save")[i % 5]
        if site == "ckpt.orbax_save":
            blob.write_bytes(b"A" * 8)
            out.append(("file", mod.fault_file(site, str(blob)) is not None))
        try:
            mod.fault_point(site)
            out.append((site, False))
        except mod.FaultInjected:
            out.append((site, True))
    mod.disarm()
    return out


@pytest.mark.parametrize("attempt", [0, 1])
@pytest.mark.parametrize("plan", PLANS, ids=["oneshot", "seeded-p",
                                             "sites"])
def test_same_plan_fires_the_same_sequence_in_both_packages(
        plan, attempt, tmp_path, monkeypatch):
    got = _fire_sequence(faults, plan, tmp_path, attempt, monkeypatch)
    want = _fire_sequence(jax_faults, plan, tmp_path, attempt, monkeypatch)
    assert got == want
    assert any(fired for _, fired in got)


# ---------------------------------------------------------------------------
# retry and backoff
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(base_s=0.5, max_s=30.0, jitter=0.5),
    dict(base_s=1.0, max_s=60.0, jitter=0.5),
    dict(base_s=0.2, max_s=0.5, factor=3.0, jitter=0.25),
    dict(base_s=1.0, max_s=8.0, jitter=0.0)])
def test_backoff_delays_match_the_jax_package(kw):
    for seed in (0, 7, 1234):
        got = list(itertools.islice(
            backoff_delays(rng=random.Random(seed), **kw), 20))
        want = list(itertools.islice(
            jax_backoff_delays(rng=random.Random(seed), **kw), 20))
        assert got == want


class TestRetry:
    def test_delays_deterministic_without_jitter(self):
        got = list(itertools.islice(backoff_delays(1.0, 8.0, jitter=0.0), 6))
        assert got == [1.0, 2.0, 4.0, 8.0, 8.0, 8.0]

    def test_jitter_bounds(self):
        got = list(itertools.islice(
            backoff_delays(1.0, 8.0, jitter=0.5, rng=random.Random(7)), 50))
        caps = [1.0, 2.0, 4.0] + [8.0] * 47
        for d, cap in zip(got, caps):
            assert 0.5 * cap <= d <= 1.5 * cap
        with pytest.raises(ValueError, match="jitter"):
            next(backoff_delays(jitter=1.5))

    def test_retries_then_succeeds(self):
        calls, sleeps, seen = [], [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        assert retry(flaky, attempts=4, jitter=0.0, base_s=1.0,
                     on_retry=lambda k, d, e: seen.append((k, d)),
                     sleep=sleeps.append) == "ok"
        assert len(calls) == 3 and sleeps == [1.0, 2.0]
        assert seen == [(1, 1.0), (2, 2.0)]

    def test_exhausted_reraises_last(self):
        with pytest.raises(OSError, match="always"):
            retry(lambda: (_ for _ in ()).throw(OSError("always")),
                  attempts=3, jitter=0.0, sleep=lambda d: None)

    def test_only_listed_exceptions_retried(self):
        def boom():
            raise KeyError("no")

        with pytest.raises(KeyError):
            retry(boom, attempts=5, retry_on=(OSError,),
                  sleep=lambda d: None)


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

def _scripted(cls, rcs, probes, metrics_path=None, **kw):
    seq, probe_seq, launches = iter(rcs), iter(probes), []

    def launch(attempt, env):
        launches.append(env[ATTEMPT_ENV])
        return next(seq)

    sup = cls(["true"], launch=launch, probe_step=lambda: next(probe_seq),
              sleep=lambda d: None, rng=random.Random(3),
              metrics_path=metrics_path, **kw)
    return sup, launches


SCRIPTS = [
    ([WEDGED_EXIT_CODE, 0], [4], {}),
    ([1, 1, 1], [5, 5, 5], dict(max_restarts=10)),
    ([1, 1, 1], [None, None, None], dict(max_restarts=2)),
    ([WEDGED_EXIT_CODE, WEDGED_EXIT_CODE, 0], [7, 7, 7],
     dict(max_restarts=5)),
    ([-9, -9], [1, 2], dict(max_restarts=1)),
    ([1] * 10, [1, 2, 3, 4, 5, 6], dict(max_restarts=3)),
    ([2], [99], {}),
    ([-15, 0], [7], {}),
    ([WEDGED_EXIT_CODE, 1, 0], [3, 5], {}),
    ([41, 41, 0], [2, 2], {}),
    ([41, 1, 1, 0], [2, 3, 3], dict(max_restarts=9)),
    ([-11, 1, WEDGED_EXIT_CODE, 1, 1], [None, 4, 4, 4, 4],
     dict(max_restarts=9)),
]


def _events(path):
    if not os.path.exists(path):
        return []
    recs = [json.loads(line) for line in open(path)]
    for r in recs:
        r.pop("time")
    return recs


@pytest.mark.parametrize("rcs,probes,kw", SCRIPTS)
def test_both_supervisors_decide_alike(rcs, probes, kw, tmp_path):
    """The same scripted (exit code, restore point) sequence: the same
    launches, restarts, backoffs, events and final exit code."""
    out = {}
    for name, cls in (("port", Supervisor),
                      ("jax", jax_supervisor.Supervisor)):
        path = str(tmp_path / f"{name}.jsonl")
        sup, launches = _scripted(cls, rcs, probes, metrics_path=path, **kw)
        out[name] = (sup.run(), sup.restarts, launches, _events(path))
    assert out["port"] == out["jax"]
    for rc in set(rcs):
        assert describe_exit(rc) == jax_supervisor.describe_exit(rc)
        assert exit_class(rc) == jax_supervisor.exit_class(rc)


class TestSupervisorUnit:
    def _sup(self, rcs, probes, **kw):
        seq, probe_seq, launches = iter(rcs), iter(probes), []

        def launch(attempt, env):
            launches.append(env[ATTEMPT_ENV])
            return next(seq)

        sup = Supervisor(["true"], launch=launch,
                         probe_step=lambda: next(probe_seq),
                         sleep=lambda d: None, **kw)
        return sup, launches

    def test_restart_on_wedge_then_success(self):
        sup, launches = self._sup([WEDGED_EXIT_CODE, 0], [4])
        assert sup.run() == 0
        assert launches == ["0", "1"] and sup.restarts == 1

    def test_two_crashes_same_step_is_deterministic(self):
        sup, launches = self._sup([1, 1, 1], [5, 5, 5], max_restarts=10)
        assert sup.run() == 1
        assert len(launches) == 2

    def test_crashes_with_no_checkpoint_yet_spend_budget(self):
        sup, launches = self._sup([1, 1, 1], [None, None, None],
                                  max_restarts=2)
        assert sup.run() == 1
        assert len(launches) == 3

    def test_repeated_wedges_same_step_keep_retrying(self):
        sup, _ = self._sup([WEDGED_EXIT_CODE, WEDGED_EXIT_CODE, 0],
                           [7, 7, 7], max_restarts=5)
        assert sup.run() == 0
        assert sup.restarts == 2

    def test_final_signal_death_maps_to_128_plus_signum(self):
        sup, _ = self._sup([-9, -9], [1, 2], max_restarts=1)
        assert sup.run() == 137

    def test_progressing_failures_use_full_budget(self):
        sup, launches = self._sup([1] * 10, [1, 2, 3, 4, 5, 6],
                                  max_restarts=3)
        assert sup.run() == 1
        assert len(launches) == 4

    def test_usage_error_never_retried(self):
        sup, launches = self._sup([2], [99])
        assert sup.run() == 2
        assert len(launches) == 1

    def test_restart_events_appended_to_metrics(self, tmp_path):
        mpath = str(tmp_path / "runs" / "metrics.jsonl")
        sup, _ = self._sup([WEDGED_EXIT_CODE, 1, 0], [3, 5],
                           metrics_path=mpath)
        assert sup.run() == 0
        recs = [json.loads(line) for line in open(mpath)]
        restarts = [r for r in recs if r["event"] == "supervisor_restart"]
        assert [r["attempt"] for r in restarts] == [1, 2]
        assert [r["exit_class"] for r in restarts] == ["wedge", "crash"]
        assert [r["restored_step"] for r in restarts] == [3, 5]
        assert all(r["backoff_s"] >= 0 and "time" in r for r in restarts)
        recovered = [r for r in recs if r["event"] == "supervisor_recovered"]
        assert len(recovered) == 1 and recovered[0]["restarts"] == 2

    def test_give_up_event_recorded(self, tmp_path):
        mpath = str(tmp_path / "metrics.jsonl")
        sup, _ = self._sup([1, 1], [5, 5], max_restarts=10,
                           metrics_path=mpath)
        assert sup.run() == 1
        give_up = [r for r in map(json.loads, open(mpath))
                   if r["event"] == "supervisor_give_up"]
        assert len(give_up) == 1
        assert give_up[0]["reason"] == "deterministic-crash"
        assert give_up[0]["restored_step"] == 5

    def test_no_metrics_path_is_quiet(self):
        sup, _ = self._sup([WEDGED_EXIT_CODE, 0], [4])
        assert sup.run() == 0

    def test_preemption_signal_retried(self):
        sup, _ = self._sup([-15, 0], [7])
        assert sup.run() == 0
        assert sup.restarts == 1

    def test_operator_signal_forwarded_not_restarted(self):
        forwarded = []

        class FakeChild:
            def poll(self):
                return None

            def send_signal(self, signum):
                forwarded.append(signum)

        def launch(attempt, env):
            sup._child = FakeChild()
            sup._on_signal(signal.SIGTERM, None)
            sup._child = None
            return -int(signal.SIGTERM)

        sup = Supervisor(["true"], launch=launch, probe_step=lambda: 1,
                         sleep=lambda d: None, max_restarts=5)
        assert sup.run() == 128 + int(signal.SIGTERM)
        assert forwarded == [signal.SIGTERM]
        assert sup.restarts == 0

    def test_stop_landing_in_spawn_window_still_forwarded(self):
        sup = Supervisor(
            [sys.executable, "-c", "import time; time.sleep(30)"],
            sleep=lambda d: None)
        sup._stop_signal = int(signal.SIGTERM)
        t0 = time.monotonic()
        assert sup._spawn(0, dict(os.environ)) == -int(signal.SIGTERM)
        assert time.monotonic() - t0 < 25

    def test_signal_during_backoff_cancels_restart(self):
        launches = []

        def launch(attempt, env):
            launches.append(attempt)
            return WEDGED_EXIT_CODE

        def sleep(d):
            sup._on_signal(signal.SIGTERM, None)

        sup = Supervisor(["true"], launch=launch, probe_step=lambda: None,
                         sleep=sleep, max_restarts=5)
        assert sup.run() == 128 + int(signal.SIGTERM)
        assert launches == [0]

    def test_subprocess_wedge_exit3_restart(self):
        """A real child wedges (a 0.4 s watchdog: exit 3), the supervisor
        relaunches it, and the second attempt succeeds."""
        script = f"""
import os, sys, time
sys.path.insert(0, {REPO!r})
from raft_tpu_torch.utils.watchdog import HangWatch
if int(os.environ.get("RAFT_SUPERVISOR_ATTEMPT", "0")) >= 1:
    sys.exit(0)
HangWatch(0.4, label="drill").start()
time.sleep(30)
"""
        sup = Supervisor([sys.executable, "-c", script], max_restarts=2,
                         probe_step=iter([1, 2]).__next__, base_s=0.05,
                         max_s=0.1)
        t0 = time.monotonic()
        assert sup.run() == 0
        assert sup.restarts == 1
        assert time.monotonic() - t0 < 20.0


class TestWatchdogPostmortem:
    def test_wedge_dumps_all_thread_stacks(self):
        script = """
import time
from raft_tpu_torch.utils.watchdog import HangWatch
HangWatch(0.3, label="pm").start()
time.sleep(30)
"""
        r = subprocess.run([sys.executable, "-c", script],
                           capture_output=True, text=True, timeout=60,
                           env=dict(os.environ, PYTHONPATH=REPO))
        assert r.returncode == WEDGED_EXIT_CODE
        assert "[watchdog] pm" in r.stderr
        assert "Current thread" in r.stderr
        assert 'File "<string>", line 5 in <module>' in r.stderr

    def test_disabled_and_stopped_watch_never_fires(self):
        from raft_tpu_torch.utils.watchdog import HangWatch

        assert HangWatch(0).start() is None
        fired = []
        w = HangWatch(0.2, on_fire=fired.append, interval=0.05)
        try:
            w.start()
        finally:
            w.stop()
        time.sleep(0.4)
        assert not fired and not w._thread.is_alive()
        w = HangWatch(0.2, on_fire=fired.append, interval=0.05)
        try:
            w.start()
            w._thread.join(5)
        finally:
            w.stop()
        assert len(fired) == 1 and fired[0] > 0.2


# ---------------------------------------------------------------------------
# the restore sandbox
# ---------------------------------------------------------------------------

class TestSandboxFallback:
    """restore_train_state reads each step through the restore sandbox and
    falls back past a torn or corrupt newest step (the JAX package's
    ``TestOrbaxFallback``)."""

    @staticmethod
    def _state(step=0):
        # a tiny state: these tests exercise save, sandbox, quarantine and
        # fallback, which see only the tree of tensors
        model = torch.nn.Linear(8, 4)
        torch.nn.init.constant_(model.weight, float(step))
        opt, sched = make_optimizer(model.parameters(), 1e-3, 10)
        model(torch.ones(2, 8)).sum().backward()
        opt.step()
        sched.step()
        return TrainState(model, opt, sched, step=step)

    def _save(self, d, *steps):
        for s in steps:
            ckpt_lib.save_train_state(d, self._state(s))

    def test_corrupt_latest_falls_back_and_quarantines(self, tmp_path,
                                                       capsys):
        d = str(tmp_path / "stage")
        faults.arm([{"site": "ckpt.orbax_save", "at": 2,
                     "kind": "corrupt"}])
        self._save(d, 1, 2)
        assert latest_step_on_disk(d) == 2
        fresh = self._state()
        ckpt_lib.restore_train_state(d, fresh)
        assert fresh.step == 1
        assert float(fresh.model.weight[0, 0]) == pytest.approx(1.0, abs=0.1)
        assert any(n.endswith(".corrupt") for n in os.listdir(d))
        assert [s for s, _ in step_dirs(d)] == [1]
        out = capsys.readouterr().out
        assert "torn/corrupt" in out and "fallback step 1" in out
        assert f"(exit {STEP_UNREADABLE_EXIT})" in out
        assert not [n for n in os.listdir(d) if "snapshot" in n]

    def test_explicit_step_fails_loudly(self, tmp_path):
        d = str(tmp_path / "stage")
        faults.arm([{"site": "ckpt.orbax_save", "kind": "corrupt"}])
        self._save(d, 5)
        with pytest.raises(ckpt_lib.StepDamagedError, match="integrity"):
            ckpt_lib.restore_train_state(d, self._state(), step=5)
        assert not [n for n in os.listdir(d) if n.endswith(".corrupt")]

    def test_env_failure_does_not_quarantine(self, tmp_path, monkeypatch):
        d = str(tmp_path / "stage")
        self._save(d, 1)

        def fake_run(*a, **kw):
            return subprocess.CompletedProcess(a, ENV_ERROR_EXIT, stdout="",
                                               stderr="disk full")

        monkeypatch.setattr(ckpt_lib.subprocess, "run", fake_run)
        with pytest.raises(RuntimeError, match="disk full"):
            ckpt_lib.restore_train_state(d, self._state())
        assert not [n for n in os.listdir(d) if n.endswith(".corrupt")]
        assert [s for s, _ in step_dirs(d)] == [1]

    def test_sandbox_timeout_quarantines_hung_step(self, tmp_path,
                                                   monkeypatch):
        d = str(tmp_path / "stage")
        self._save(d, 1, 2)
        monkeypatch.setenv("RAFT_RESTORE_TIMEOUT_S", "123")
        real_run = subprocess.run
        seen = []

        def fake_run(cmd, **kw):
            seen.append(kw["timeout"])
            if os.path.basename(cmd[-2]) == "2":
                raise subprocess.TimeoutExpired(cmd, kw.get("timeout"))
            return real_run(cmd, **kw)

        monkeypatch.setattr(ckpt_lib.subprocess, "run", fake_run)
        fresh = self._state()
        ckpt_lib.restore_train_state(d, fresh)
        assert fresh.step == 1 and seen == [123.0, 123.0]
        assert any(n.endswith(".corrupt") for n in os.listdir(d))
        assert [s for s, _ in step_dirs(d)] == [1]

    def test_oom_signal_death_does_not_quarantine(self, tmp_path,
                                                  monkeypatch):
        d = str(tmp_path / "stage")
        self._save(d, 1)

        def fake_run(*a, **kw):
            return subprocess.CompletedProcess(a, -9, stdout="",
                                               stderr="oom-killed")

        monkeypatch.setattr(ckpt_lib.subprocess, "run", fake_run)
        with pytest.raises(RuntimeError, match="oom-killed"):
            ckpt_lib.restore_train_state(d, self._state())
        assert not [n for n in os.listdir(d) if n.endswith(".corrupt")]
        assert [s for s, _ in step_dirs(d)] == [1]

    def test_sandbox_crash_signal_quarantines(self, tmp_path, monkeypatch):
        d = str(tmp_path / "stage")
        self._save(d, 1, 2)
        real_run = subprocess.run
        envs = []

        def fake_run(cmd, **kw):
            envs.append(kw["env"])
            if os.path.basename(cmd[-2]) == "2":
                return subprocess.CompletedProcess(cmd, -11, stdout="",
                                                   stderr="segfault")
            return real_run(cmd, **kw)

        monkeypatch.setattr(ckpt_lib.subprocess, "run", fake_run)
        monkeypatch.setenv("RAFT_FAULT_PLAN", "[]")
        fresh = self._state()
        ckpt_lib.restore_train_state(d, fresh)
        assert fresh.step == 1
        assert any(n.endswith(".corrupt") for n in os.listdir(d))
        # the sandbox never claims the card and never sees a plan
        assert all(e["CUDA_VISIBLE_DEVICES"] == "" for e in envs)
        assert not any("RAFT_FAULT_PLAN" in e for e in envs)

    def test_all_steps_corrupt_raises_with_inventory(self, tmp_path):
        d = str(tmp_path / "stage")
        faults.arm([{"site": "ckpt.orbax_save", "kind": "corrupt"},
                    {"site": "ckpt.orbax_save", "at": 2,
                     "kind": "corrupt"}])
        self._save(d, 1, 2)
        with pytest.raises(FileNotFoundError, match="quarantined"):
            ckpt_lib.restore_train_state(d, self._state())

    def test_sandbox_exit_codes(self, tmp_path):
        """The sandbox on its own: 0 with a verified snapshot, 4 for a step
        that cannot be read, 5 when the snapshot cannot be written."""
        from raft_tpu_torch.tools.convert import load_verified
        from raft_tpu_torch.training import restore_sandbox

        d = str(tmp_path / "stage")
        self._save(d, 3)
        step = os.path.join(d, "3")
        snap = str(tmp_path / "snap.pt")
        assert restore_sandbox.main([step, snap]) == 0
        assert load_verified(snap)["step"] == 3
        assert restore_sandbox.main([str(tmp_path / "nope"), snap]) == 4
        blocked = tmp_path / "file"
        blocked.write_text("")
        assert restore_sandbox.main([step, str(blocked / "x.pt")]) == 5
        assert restore_sandbox.main([step]) == 2


def test_fault_site_in_loader_worker_respects_skip_policy():
    from raft_tpu_torch.data.loader import PrefetchLoader

    class Samples:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            img = np.zeros((8, 8, 3), np.float32)
            return img, img, np.zeros((8, 8, 2), np.float32), np.ones(
                (8, 8), np.float32)

    faults.arm([{"site": "loader.sample", "kind": "raise"}])
    loader = PrefetchLoader(Samples(), 4, shuffle=False, num_workers=1,
                            on_bad_sample="skip")
    with pytest.warns(UserWarning, match="FaultInjected"):
        batches = list(loader)
    assert len(batches) == 2 and loader.bad_samples == 1


def test_loader_start_at_continues_the_batch_sequence():
    """A loader moved to step s yields what an uninterrupted one yields
    from its batch s on (one worker, whole epochs)."""
    from raft_tpu_torch.data.loader import PrefetchLoader

    class Samples:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            v = np.full((2, 2, 3), i, np.float32)
            return v, v, np.zeros((2, 2, 2), np.float32), np.ones(
                (2, 2), np.float32)

    def firsts(loader, epochs):
        return [b["image1"][:, 0, 0, 0].tolist() for _ in range(epochs)
                for b in loader]

    full = firsts(PrefetchLoader(Samples(), 2, num_workers=1), 3)
    moved = PrefetchLoader(Samples(), 2, num_workers=1)
    moved.start_at(4)
    assert firsts(moved, 2) == full[4:]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

class TestTrainCLISupervise:
    def test_parser_exposes_robustness_knobs(self):
        from raft_tpu_torch.cli.train import build_parser, configs_from_args

        args = build_parser().parse_args(
            ["--stage", "chairs", "--hang_s", "120", "--supervise",
             "--max_restarts", "7"])
        assert args.supervise and args.max_restarts == 7
        _, tcfg = configs_from_args(args)
        assert tcfg.hang_s == 120.0
        args = build_parser().parse_args(["--stage", "chairs"])
        assert args.max_restarts == 5
        assert configs_from_args(args)[1].hang_s == 0.0

    def test_abbreviated_flags_rejected(self, capsys):
        from raft_tpu_torch.cli.train import build_parser

        with pytest.raises(SystemExit):
            build_parser().parse_args(["--stage", "chairs", "--superv"])
        capsys.readouterr()

    def test_supervise_builds_resumed_child(self, tmp_path, monkeypatch):
        import raft_tpu_torch.training.supervisor as sup_mod
        from raft_tpu_torch.cli import train as cli_train

        captured = {}

        class FakeSup:
            def __init__(self, argv, **kw):
                captured["argv"] = argv
                captured.update(kw)

            def run(self):
                return 0

        monkeypatch.setattr(sup_mod, "Supervisor", FakeSup)
        argv = ["--stage", "chairs", "--name", "n", "--supervise",
                "--max_restarts", "2", "--hang_s", "9",
                "--checkpoint_dir", str(tmp_path)]
        with pytest.raises(SystemExit) as ei:
            cli_train.main(argv)
        assert ei.value.code == 0
        child = captured["argv"]
        assert child[:3] == [sys.executable, "-m", "raft_tpu_torch.cli.train"]
        tail = child[3:]
        assert "--supervise" not in tail and "--max_restarts" not in tail
        assert "2" not in tail and "--hang_s" in tail
        assert tail[-1] == "--resume"
        assert captured["max_restarts"] == 2
        assert captured["ckpt_dir"] == os.path.join(str(tmp_path), "n",
                                                    "chairs")
        assert captured["metrics_path"] == os.path.join("runs", "n",
                                                        "metrics.jsonl")


def test_hang_watch_is_stopped_when_train_returns(tmp_path):
    """An in-process train() with a watch leaves no watcher behind (on the
    normal path; the same finally covers an exception)."""
    from raft_tpu_torch.config import RAFTConfig, stage_config
    from raft_tpu_torch.training.trainer import train

    rng = np.random.RandomState(0)
    im = rng.randint(0, 256, (1, 32, 32, 3)).astype(np.uint8)
    batch = {"image1": im, "image2": im,
             "flow": np.zeros((1, 32, 32, 2), np.float32),
             "valid": np.ones((1, 32, 32), np.uint8)}
    tc = stage_config("chairs", name="hw", batch_size=1, image_size=(32, 32),
                      iters=1, num_steps=2, validation=(), hang_s=60.0,
                      checkpoint_dir=str(tmp_path / "ckpt"),
                      log_dir=str(tmp_path / "runs"))
    train(RAFTConfig(small=True), tc, loader=[batch], device="cpu")
    assert not [t for t in threading.enumerate()
                if t.name.startswith("HangWatch") and t.is_alive()]


# ---------------------------------------------------------------------------
# the end-to-end drill
# ---------------------------------------------------------------------------

DRILL_TIMEOUT_S = 150


def _run(cmd, env, cwd):
    """``cmd`` in its own session, killed with everything it started if it
    outlives DRILL_TIMEOUT_S (a supervisor's child outlives the supervisor
    killed alone)."""
    proc = subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DRILL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"{cmd[3:]} did not finish in {DRILL_TIMEOUT_S}s: "
                    f"{out[-3000:]}")
    return proc.returncode, out


def test_supervised_drill_recovers_bitwise(tmp_path):
    """Attempt 0 corrupts its second full-state save (step 3) and hangs
    before its fourth step; the watchdog exits 3; attempt 1 resumes,
    quarantines step 3 through the sandbox, falls back to step 1, and the
    final weights equal the uninterrupted run's bitwise."""
    # TensorBoard's writer imports TensorFlow where it is installed, which
    # can take seconds a process; the drill's processes see it absent, and
    # TensorBoard takes its own stub
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        "import sys\nsys.modules['tensorflow'] = None\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), REPO]),
               OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    env.pop("RAFT_FAULT_PLAN", None)
    base = [sys.executable, "-m", "raft_tpu_torch.cli.train", "--device",
            "cpu", "--small", "--synthetic", "2", "--batch_size", "2",
            "--image_size", "64", "96", "--iters", "2", "--num_workers", "1",
            "--num_steps", "6", "--val_freq", "2",
            "--synthetic_dir", str(tmp_path / "syn"),
            "--data_root", str(tmp_path / "data"),
            "--log_dir", str(tmp_path / "runs")]
    t0 = time.monotonic()
    rc, out = _run(base + ["--name", "ctl", "--checkpoint_dir",
                           str(tmp_path / "ctl")], env, str(tmp_path))
    assert rc == 0, out[-3000:]

    plan = [{"site": "ckpt.orbax_save", "at": 2, "kind": "corrupt",
             "attempt": 0},
            {"site": "trainer.step", "at": 4, "kind": "hang", "attempt": 0}]
    env["RAFT_FAULT_PLAN"] = json.dumps(plan)
    rc, out = _run(base + ["--name", "sup", "--checkpoint_dir",
                           str(tmp_path / "sup"), "--supervise",
                           "--max_restarts", "3", "--hang_s", "4"],
                   env, str(tmp_path))
    assert rc == 0, out[-3000:]
    assert "[watchdog] train loop: no progress" in out
    assert "child wedged (exit 3" in out
    assert "restore sandbox failed" in out and "(exit 4)" in out
    assert "resumed from fallback step 1 (skipped corrupt step(s) [3])" in out
    stage = tmp_path / "sup" / "sup" / "chairs"
    assert sorted(os.listdir(stage)) == ["1", "3", "3.corrupt", "5"]
    events = [json.loads(line) for line in open(
        tmp_path / "runs" / "sup" / "metrics.jsonl")]
    restarts = [e for e in events if e.get("event") == "supervisor_restart"]
    assert restarts and restarts[0]["exit_class"] == "wedge"
    assert restarts[0]["restored_step"] == 3
    assert [e["restarts"] for e in events
            if e.get("event") == "supervisor_recovered"] == [len(restarts)]
    ctl = (tmp_path / "ctl" / "ctl.pth").read_bytes()
    sup = (tmp_path / "sup" / "sup.pth").read_bytes()
    assert ctl == sup
    assert time.monotonic() - t0 < 2 * DRILL_TIMEOUT_S
