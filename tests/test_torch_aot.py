"""The port's program store (``raft_tpu_torch/serving/aot.py``) against
``tests/test_aot_cache.py``, case for case where the case applies, on the
CPU at the small config (the trained fixture, 32x32, iters 1).

Every claim rests on the engine's and the store's own counters, never on
timing: ``compiles == 0`` with ``aot_hits`` equal to the programs built is
the warm start, and bitwise-equal flow is what makes a loaded program
interchangeable with a traced one. The port's payload is the bucket
program's ``torch.export`` program, so a load in the same process is as
good as one in a fresh process (JAX's in-process reload rolls a CPU
symbol-registry quirk; this one does not), and the cross-process case is
the host drill's (``tests/test_torch_hosts.py``). The other half is the
trust model: every corruption, skew and stale key reads as a clean MISS
(``load`` returns None and the engine traces the live module), never a
wrong program and never a raise into serving. The warm engine is also held
to ``raft_tpu``'s engine on the same weights and inputs within 5e-4 px,
and the key's digest to JAX's ``key_digest`` byte for byte.
"""

import json
import os
import os.path as osp
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.kernels import corr_pallas, gru_pallas
from raft_tpu.serving import aot as jax_aot
from raft_tpu.serving.engine import RAFTEngine as JaxEngine
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.serving import aot
from raft_tpu_torch.serving.engine import RAFTEngine
from raft_tpu_torch.serving.registry import ModelRegistry
from raft_tpu_torch.testing import faults
from raft_tpu_torch.tools.convert import load_pth

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(REPO, "tests", "fixtures", "raft-small-cputrained")
SMALL = RAFTConfig(small=True)
TOL = 5e-4          # px: the ROADMAP's end-to-end bound against raft_tpu
WAIT = 120


@pytest.fixture(autouse=True)
def _disarm_after():
    yield
    faults.disarm()


@pytest.fixture(scope="module")
def model():
    return load_pth(FIXTURE + ".pth", SMALL).eval()


@pytest.fixture(scope="module")
def images():
    rs = np.random.RandomState(1234)
    return ((rs.rand(1, 32, 32, 3) * 255).astype(np.float32),
            (rs.rand(1, 32, 32, 3) * 255).astype(np.float32))


def _engine(model, store, **kw):
    return RAFTEngine(model, SMALL, iters=1, envelope=[], precompile=False,
                      aot_cache=store, device="cpu", **kw)


@pytest.fixture(scope="module")
def warm_store(model, images, tmp_path_factory):
    """One cold engine over an empty store: it exports and stores the
    (1, 32, 32) program. Returns the store's root and the cold flow; a
    test that writes to the store works on a copy (:func:`_copy`)."""
    root = str(tmp_path_factory.mktemp("aot") / "store")
    eng = _engine(model, root)
    flow = eng.infer_batch(*images)
    return root, flow, eng.aot_stats()


def _copy(warm_store, tmp_path):
    dst = str(tmp_path / "store")
    shutil.copytree(warm_store[0], dst)
    return dst


def _full_key(**overrides):
    """A complete key for the direct-AOTCache tests."""
    key = {
        "format": aot.AOT_FORMAT,
        "program": "test",
        "weights": "w" * 16,
        "geometry": [1, 8],
        "wire": "f32",
        "iters": 1,
        "config": "c" * 16,
        "donations": "none",
        "partition": "single",
        **aot.runtime_fields("cpu"),
    }
    key.update(overrides)
    return key


class _Affine(torch.nn.Module):
    def forward(self, x):
        return x * 2.0 + 1.0


@pytest.fixture(scope="module")
def tiny_program():
    return torch.export.export(_Affine(), (torch.arange(8.0),))


def _store_tiny(root, program, **key_overrides):
    cache = aot.AOTCache(root)
    key = _full_key(**key_overrides)
    edir = cache.store(key, program)
    assert edir is not None
    return cache, key, edir


# -- the engine seam ----------------------------------------------------------


class TestEngineWarmStart:
    def test_in_process_warm_start_zero_compiles_bitwise(
            self, model, images, warm_store, tmp_path, monkeypatch):
        root, cold_flow, cold = warm_store
        assert cold["enabled"] == 1
        assert cold["compiles"] == 1 and cold["aot_misses"] == 1
        assert cold["aot_hits"] == 0 and cold["captures"] == 1
        # a second engine over the same store: the restarted replica
        eng = _engine(model, _copy(warm_store, tmp_path))
        flow = eng.infer_batch(*images)
        s = eng.aot_stats()
        assert s["compiles"] == 0, (s, eng._aot.last_miss)
        assert s["aot_hits"] == 1 and s["compiles_avoided"] == 1
        assert s["captures"] == 1
        assert np.array_equal(flow, cold_flow)   # bitwise, not allclose

        # the warm engine against raft_tpu's on the same converted weights
        monkeypatch.setattr(corr_pallas, "_INTERPRET", True)
        monkeypatch.setattr(gru_pallas, "_INTERPRET", True)
        with open(FIXTURE + ".msgpack", "rb") as fh:
            variables = jax.tree_util.tree_map(
                jnp.asarray, serialization.msgpack_restore(fh.read()))
        want = np.asarray(JaxEngine(
            variables, JaxConfig(small=True), iters=1, envelope=[],
            precompile=False).infer_batch(*images))
        assert float(np.abs(flow - want).max()) <= TOL

    def test_weights_swap_invalidates_then_old_artifact_rehits(
            self, model, images, warm_store, tmp_path):
        store = _copy(warm_store, tmp_path)
        eng = _engine(model, store)
        bucket = eng.ensure_bucket(1, 32, 32)
        assert eng.aot_stats()["aot_hits"] == 1

        # same structure and shapes, other content: a genuinely new
        # checkpoint must MISS, never load the old model's program, and
        # the swap after a warm start reaches the loaded program
        swapped = {k: (v + 1e-3 if v.is_floating_point() else v)
                   for k, v in model.state_dict().items()}
        eng.update_weights(swapped)
        flow_new = eng.infer_batch(*images)
        twin = RAFTEngine(swapped, SMALL, iters=1, device="cpu")
        assert np.array_equal(flow_new, twin.infer_batch(*images))
        assert eng.drop_bucket(bucket)
        eng.ensure_bucket(1, 32, 32)
        s = eng.aot_stats()
        assert s["compiles"] == 1 and s["aot_misses"] == 1, s
        assert len(os.listdir(osp.join(store, "objects"))) == 2

        # swapping BACK re-keys to the first entry, and it loads again
        eng.update_weights(model.state_dict())
        assert eng.drop_bucket(bucket)
        assert np.array_equal(eng.infer_batch(*images), warm_store[1])
        s = eng.aot_stats()
        assert s["aot_hits"] == 2 and s["compiles"] == 1, s
        edir = eng._aot.entry_dir(eng._aot_key(bucket))
        with open(osp.join(edir, "manifest.json"), encoding="utf-8") as f:
            assert json.load(f)["key"] == eng._aot_key(bucket)

    def test_disabled_engine_reports_disabled(self, model):
        eng = RAFTEngine(model, SMALL, iters=1, envelope=[],
                         precompile=False, device="cpu")
        s = eng.aot_stats()
        assert s["enabled"] == 0
        assert s["aot_hits"] == 0 and s["aot_misses"] == 0

    def test_unexportable_program_stores_nothing(self, model, images,
                                                 tmp_path, monkeypatch):
        """A bucket program that will not export stores nothing, and the
        engine serves its live module all the same."""
        from raft_tpu_torch.serving import engine as engine_mod

        def refuse(*a, **k):
            raise RuntimeError("this program will not export")

        monkeypatch.setattr(engine_mod, "export_bucket", refuse)
        eng = _engine(model, str(tmp_path / "store"))
        flow = eng.infer_batch(*images)
        s = eng.aot_stats()
        assert s["compiles"] == 1 and s["aot_misses"] == 1
        assert not osp.isdir(osp.join(str(tmp_path / "store"), "objects"))
        plain = RAFTEngine(model, SMALL, iters=1, device="cpu")
        assert np.array_equal(flow, plain.infer_batch(*images))


# -- the trust model (direct AOTCache) ------------------------------------------


class TestVerifiedLoad:
    def test_roundtrip_hits_and_runs(self, tiny_program, tmp_path):
        _, key, _ = _store_tiny(str(tmp_path), tiny_program)
        fresh = aot.AOTCache(str(tmp_path))
        program = fresh.load(key)
        assert program is not None, fresh.last_miss
        out = program.module()(torch.arange(8.0))
        assert torch.equal(out, torch.arange(8.0) * 2.0 + 1.0)
        assert fresh.stats() == {"hits": 1, "misses": 0, "stores": 0}

    @pytest.mark.parametrize("tamper,reason", [
        ("blob-truncate", "blob hash mismatch"),
        ("blob-bit-flip", "blob hash mismatch"),
        ("manifest-torn", "JSONDecodeError"),
        ("manifest-version-skew", "format skew"),
        ("manifest-key-swap", "key mismatch"),
        ("blob-unloadable", None),
    ])
    def test_corruption_routes_to_miss(self, tiny_program, tmp_path,
                                       tamper, reason):
        """Every damage shape reads as a clean miss with the RIGHT
        diagnosis, and the pristine entry still verifies afterwards."""
        _, key, edir = _store_tiny(str(tmp_path), tiny_program)
        backup = str(tmp_path / "backup")
        shutil.copytree(edir, backup)
        blob = osp.join(edir, "executable.bin")
        manifest = osp.join(edir, "manifest.json")
        with open(blob, "rb") as f:
            data = f.read()
        with open(manifest, encoding="utf-8") as f:
            m = json.load(f)
        if tamper == "blob-truncate":
            with open(blob, "wb") as f:
                f.write(data[:len(data) // 2])
        elif tamper == "blob-bit-flip":
            flipped = bytearray(data)
            flipped[len(flipped) // 2] ^= 0x40
            with open(blob, "wb") as f:
                f.write(bytes(flipped))
        elif tamper == "manifest-torn":
            text = json.dumps(m)
            with open(manifest, "w", encoding="utf-8") as f:
                f.write(text[:len(text) // 2])
        elif tamper == "manifest-version-skew":
            with open(manifest, "w", encoding="utf-8") as f:
                json.dump(dict(m, format="torch_export_v0"), f)
        elif tamper == "manifest-key-swap":
            with open(manifest, "w", encoding="utf-8") as f:
                json.dump(dict(m, key=dict(m["key"], weights="f" * 16)), f)
        elif tamper == "blob-unloadable":
            # a blob whose hash the manifest vouches for, that is not a
            # program: the load itself fails, and that is a miss too
            junk = b"not a program archive"
            import hashlib
            with open(blob, "wb") as f:
                f.write(junk)
            with open(manifest, "w", encoding="utf-8") as f:
                json.dump(dict(m, sha256=hashlib.sha256(junk).hexdigest()),
                          f)
        fresh = aot.AOTCache(str(tmp_path))
        assert fresh.load(key) is None
        if reason is None:   # the load's own error, whatever its name
            assert fresh.last_miss not in (
                "absent", "format skew", "key mismatch",
                "blob hash mismatch"), fresh.last_miss
        else:
            assert reason in fresh.last_miss, fresh.last_miss
        assert fresh.stats()["misses"] == 1
        shutil.rmtree(edir)
        shutil.copytree(backup, edir)
        assert fresh._entry_valid(edir, key)
        assert fresh.load(key) is not None

    def test_stale_key_is_absent_miss(self, tiny_program, tmp_path):
        _, key, _ = _store_tiny(str(tmp_path), tiny_program)
        fresh = aot.AOTCache(str(tmp_path))
        assert fresh.load(dict(key, weights="f" * 16)) is None
        assert fresh.last_miss == "absent"

    def test_store_refuses_incomplete_key(self, tiny_program, tmp_path):
        key = _full_key()
        del key["weights"]
        with pytest.raises(ValueError, match="weights"):
            aot.AOTCache(str(tmp_path)).store(key, tiny_program)

    def test_unserializable_program_stores_none(self, tmp_path):
        """Something that is not a program cannot be saved: store
        declines (None) and never raises; the store accelerates, it never
        gates."""
        assert aot.AOTCache(str(tmp_path)).store(_full_key(),
                                                 object()) is None
        objects = osp.join(str(tmp_path), "objects")
        assert not osp.isdir(objects) or not os.listdir(objects)

    def test_store_replaces_invalid_entry(self, tiny_program, tmp_path):
        _, key, edir = _store_tiny(str(tmp_path), tiny_program)
        with open(osp.join(edir, "executable.bin"), "wb") as f:
            f.write(b"\0" * 64)
        _, _, edir2 = _store_tiny(str(tmp_path), tiny_program)
        assert edir2 == edir
        assert aot.AOTCache(str(tmp_path))._entry_valid(edir, key)


# -- the store's GC --------------------------------------------------------------


class TestEvict:
    def _seed(self, root, program, n=3):
        """``n`` entries under distinct weights fingerprints, their
        manifests' mtimes staggered oldest first (entry 0 oldest)."""
        cache = aot.AOTCache(root)
        keys = [_full_key(weights=f"w{i}" * 8) for i in range(n)]
        dirs = []
        now = __import__("time").time()
        for i, key in enumerate(keys):
            edir = cache.store(key, program)
            assert edir is not None
            mtime = now - 1000.0 + 100.0 * i
            os.utime(osp.join(edir, "manifest.json"), (mtime, mtime))
            dirs.append(edir)
        return cache, keys, dirs

    def test_weights_policy_removes_only_matching(self, tiny_program,
                                                  tmp_path):
        cache, keys, dirs = self._seed(str(tmp_path), tiny_program)
        out = cache.evict(weights=keys[1]["weights"])
        assert out["removed"] == 1 and out["remaining"] == 2
        assert out["removed_bytes"] > 0
        assert not osp.isdir(dirs[1])
        assert osp.isdir(dirs[0]) and osp.isdir(dirs[2])
        assert cache._entry_valid(dirs[0], keys[0])

    def test_max_age_removes_stale_entries(self, tiny_program, tmp_path):
        cache, _, dirs = self._seed(str(tmp_path), tiny_program)
        # entries sit at ages ~1000 s / 900 s / 800 s: cut at 850
        out = cache.evict(max_age_s=850.0)
        assert out["removed"] == 2 and out["remaining"] == 1
        assert osp.isdir(dirs[2])

    def test_max_bytes_evicts_oldest_first(self, tiny_program, tmp_path):
        cache, _, dirs = self._seed(str(tmp_path), tiny_program)
        per = osp.getsize(osp.join(dirs[0], "executable.bin"))
        out = cache.evict(max_bytes=int(per * 1.5))
        assert out["removed"] == 2 and out["remaining"] == 1
        assert out["remaining_bytes"] <= per * 1.5
        # the NEWEST entry (the one a warm restart wants) survived
        assert osp.isdir(dirs[2])
        assert not osp.isdir(dirs[0]) and not osp.isdir(dirs[1])

    def test_torn_entry_reads_as_oldest_garbage(self, tiny_program,
                                                tmp_path):
        self._seed(str(tmp_path), tiny_program)
        cache = aot.AOTCache(str(tmp_path))
        torn = osp.join(str(tmp_path), "objects", "deadbeef")
        os.makedirs(torn)
        with open(osp.join(torn, "manifest.json"), "w",
                  encoding="utf-8") as f:
            f.write("{not json")
        out = cache.evict(max_age_s=3600.0)
        assert not osp.isdir(torn)          # mtime 0.0: first to go
        assert out["remaining"] == 3        # real entries untouched

    def test_empty_store_is_a_noop(self, tmp_path):
        out = aot.AOTCache(str(tmp_path)).evict(max_bytes=0)
        assert out == {"removed": 0, "removed_bytes": 0,
                       "remaining": 0, "remaining_bytes": 0}


class TestRegistryRetirementGC:
    def test_rollback_evicts_canary_artifacts_keeps_live(
            self, model, warm_store, tmp_path):
        """A rolled-back canary's programs leave the shared store with it;
        the live fingerprint's stay (a warm restart still loads them), and
        the eviction is an ``aot_evicted`` event."""
        adir = _copy(warm_store, tmp_path)
        mpath = str(tmp_path / "metrics.jsonl")
        objs = osp.join(adir, "objects")
        reg = ModelRegistry(metrics_path=mpath, gather_window_s=0.0,
                            device="cpu")
        try:
            reg.add_model("m", model.state_dict(), SMALL, iters=1,
                          envelope=[(1, 32, 32)], artifact_dir=adir)
            swapped = {k: (v + 1e-3 if v.is_floating_point() else v)
                       for k, v in model.state_dict().items()}
            reg.deploy("m", swapped, canary_fraction=0.5,
                       artifact_dir=adir)
            assert len(os.listdir(objs)) == 2
            live = reg._models["m"].live.engine
            assert live.aot_stats()["aot_hits"] == 1
            reg.rollback("m")
            remaining = os.listdir(objs)
            assert len(remaining) == 1
            with open(osp.join(objs, remaining[0], "manifest.json"),
                      encoding="utf-8") as f:
                assert json.load(f)["key"]["weights"] == live._weights_fp
            events = [json.loads(line) for line in open(mpath)]
            gone = [e for e in events if e.get("event") == "aot_evicted"]
            assert len(gone) == 1 and gone[0]["removed"] == 1
        finally:
            reg.close()


# -- the chaos surface -------------------------------------------------------------


class TestFaultSite:
    def test_fault_point_raise_reads_as_miss(self, tiny_program, tmp_path):
        _, key, _ = _store_tiny(str(tmp_path), tiny_program)
        cache = aot.AOTCache(str(tmp_path))
        faults.arm([{"site": "aot.load", "kind": "raise"}])
        assert cache.load(key) is None
        assert "FaultInjected" in cache.last_miss
        faults.disarm()
        # the entry itself was never damaged
        assert cache._entry_valid(cache.entry_dir(key), key)

    def test_fault_file_corrupt_reads_as_miss(self, tiny_program,
                                              tmp_path):
        _, key, _ = _store_tiny(str(tmp_path), tiny_program)
        cache = aot.AOTCache(str(tmp_path))
        faults.arm([{"site": "aot.load", "kind": "corrupt",
                     "at": 1, "count": 1}])
        assert cache.load(key) is None
        assert cache.last_miss == "blob hash mismatch"

    def test_engine_recompiles_cleanly_through_corrupt_artifact(
            self, model, images, warm_store, tmp_path):
        """A corrupted entry mid-run reads as a miss, the engine traces
        the live module again, and the re-stored entry is valid."""
        eng = _engine(model, _copy(warm_store, tmp_path))
        out1 = eng.infer_batch(*images)
        bucket = eng.ensure_bucket(1, 32, 32)
        assert eng.drop_bucket(bucket)
        faults.arm([{"site": "aot.load", "kind": "corrupt",
                     "at": 1, "count": 1}])
        out2 = eng.infer_batch(*images)
        faults.disarm()
        s = eng.aot_stats()
        assert s["aot_hits"] == 1 and s["aot_misses"] == 1, s
        assert s["compiles"] == 1 and s["captures"] == 2, s
        assert np.array_equal(out1, out2)
        key = eng._aot_key(bucket)
        assert eng._aot._entry_valid(eng._aot.entry_dir(key), key)


# -- the registry seam -------------------------------------------------------------


class TestRegistryArtifactDir:
    def test_add_model_threads_artifact_dir(self, model, warm_store,
                                            tmp_path):
        """``artifact_dir=`` arms the engine the registry builds, and its
        envelope loads from the warm store."""
        adir = _copy(warm_store, tmp_path)
        reg = ModelRegistry(gather_window_s=0.0, device="cpu")
        try:
            reg.add_model("m", model.state_dict(), SMALL, iters=1,
                          envelope=[(1, 32, 32)], artifact_dir=adir)
            live = reg._models["m"].live.engine
            s = live.aot_stats()
            assert s["enabled"] == 1 and s["aot_hits"] == 1
            assert s["compiles"] == 0
            assert live._aot.root == osp.abspath(adir)
            assert len(os.listdir(osp.join(adir, "objects"))) == 1
        finally:
            reg.close()


# -- one key algorithm across the packages ------------------------------------------


def test_key_digest_matches_jax_byte_for_byte(model, tmp_path):
    eng = _engine(model, str(tmp_path))     # builds nothing
    keys = [_full_key(), _full_key(geometry=[4, 440, 1024], wire="u8"),
            eng._aot_key((1, 32, 32)), eng._aot_key((2, 64, 64), "cached"),
            {"weights": "é", "nested": {"b": [1, 2.5, None], "a": True}}]
    for key in keys:
        assert aot.key_digest(key) == jax_aot.key_digest(key)
    assert aot.REQUIRED_KEY_FIELDS == jax_aot.REQUIRED_KEY_FIELDS
    assert aot.REQUIRED_KEY_FIELDS <= set(eng._aot_key((1, 32, 32)))
