"""The program store: each serving bucket's program, exported once, behind
a content-addressed on-disk store; port of ``raft_tpu/serving/aot.py``.

The reference deployment serializes its inference program once and ships
the artifact (ONNX -> TensorRT, ``cvt2trt.*``). The JAX engine stores
serialized XLA executables, so a fresh process loads them and compiles
nothing. On CUDA no captured graph survives its process, so the payload
here is the bucket program's ``torch.export`` ``ExportedProgram``
(``torch.export.save``, a ``.pt2`` archive), which holds the port's
kernels as the ``raft_tpu_torch::corr_lookup``, ``::gru_gates`` and
``::gru_blend`` operators. A hit replaces tracing the live module; every
process still captures its own CUDA graph of the loaded program.

Trust model, the JAX store's:

- The KEY is the program's full provenance: a content fingerprint of the
  weights (a restarting process re-derives the same key from the same
  checkpoint), the bucket geometry and program kind, the wire dtype, the
  iteration count and the config, the donations (``"none"``: a captured
  graph's static inputs are the engine's own buffers), the partition
  (``"single"``), and the runtime that traced it. The twelve field names
  are the JAX store's; its three version fields carry torch's version
  (``jax``), the CUDA and cuDNN versions (``jaxlib``) and the device name
  with its compute capability (``platform``). The engine adds the
  process's TF32 flags (``tf32``), which change the numbers. The
  canonical-JSON sha256 of the key names the entry directory, byte for
  byte the JAX store's algorithm.
- Every entry carries a MANIFEST: the full key (checked verbatim on load,
  so a blob at the wrong digest never loads), the blob's sha256 (checked
  before ``torch.export.load`` reads a byte), and the program's calling
  convention (input and output dtypes and shapes).
- ANY verification failure (an unreadable or torn manifest, a key
  mismatch, version skew, a hash mismatch, a load error) is a clean MISS:
  :meth:`AOTCache.load` returns ``None`` and the caller builds from the
  live module. No failure loads a wrong program, and none raises into the
  serving path.
- Writes are atomic (a fully written temporary directory published by
  ``rename``, the manifest written last) and the first insert wins; an
  existing entry that fails verification is replaced, so one corrupted
  blob cannot wedge a digest.

Fault site ``aot.load`` (testing/faults.py): ``fault_file`` corrupts the
entry on disk before the read and ``fault_point`` raises inside the
verification scope; both must read as a miss.

The store accelerates and never gates: :meth:`AOTCache.store` swallows
save and IO errors, and a program that will not export stores nothing
(the engine then captures its live module).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import tempfile
import time
from typing import Dict, Optional

from raft_tpu_torch.testing.faults import fault_file, fault_point

#: bump when the entry layout or payload changes: old entries then read
#: as a miss, never as a misparse
AOT_FORMAT = "torch_export_v1"

#: every component a complete key must carry (the JAX store's twelve
#: names): a key missing one is a stale-load hazard, since two programs
#: differing only in it would share a digest
REQUIRED_KEY_FIELDS = frozenset({
    "format",     # AOT_FORMAT: layout and payload version
    "program",    # serve | serve_warm | serve_cached | serve_ragged...
    "weights",    # content fingerprint of the state dict
    "geometry",   # bucket or class (batch, H, W)
    "wire",       # f32 | u8 boundary dtype
    "iters",      # refinement iterations baked into the trace
    "config",     # model config fingerprint
    "donations",  # "none": the engine's static buffers are the inputs
    "partition",  # "single"
    "jax",        # the runtime: torch's version
    "jaxlib",     # the CUDA and cuDNN versions
    "platform",   # the device name and compute capability, or "cpu"
})

_MANIFEST = "manifest.json"
_BLOB = "executable.bin"


# -- fingerprints ---------------------------------------------------------

def weights_fingerprint(weights) -> str:
    """Content hash over a state dict (or a module's) in sorted key
    order: each entry's name, dtype, shape and bytes. Derivable in any
    process holding the same checkpoint, which is what makes a fresh
    process key to the same entries, and changed by any weight swap, so a
    swapped model never loads the old model's program."""
    import torch

    if isinstance(weights, torch.nn.Module):
        weights = weights.state_dict()
    h = hashlib.sha256()
    for name in sorted(weights):
        t = torch.as_tensor(weights[name])
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        # raw bytes on the host (a bf16 tensor has no numpy dtype)
        h.update(t.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def config_fingerprint(config, iters: int) -> str:
    """The architecture component of the key: the dataclass repr is
    stable and covers every knob that changes the traced program."""
    h = hashlib.sha256(repr(config).encode())
    h.update(str(int(iters)).encode())
    return h.hexdigest()[:16]


def partition_fingerprint(mesh=None, declared_specs=()) -> str:
    """The mesh's axis names and shape and the declared spec table
    (``Partitioner.declared_specs``), or ``"single"`` for the one-device
    engine without a mesh. The shape counts devices: a program laid out
    for one mesh never loads into an engine on another."""
    if mesh is None:
        return "single"
    h = hashlib.sha256()
    h.update(repr(tuple(mesh.axis_names)).encode())
    h.update(repr(tuple(mesh.devices.shape)).encode())
    h.update(repr(tuple(declared_specs)).encode())
    return h.hexdigest()[:16]


def runtime_fields(device) -> Dict:
    """The key's runtime components for programs traced on ``device``:
    torch's version, the CUDA and cuDNN versions, the device's name and
    compute capability, and the process's TF32 flags."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        cap = torch.cuda.get_device_capability(device)
        platform = (f"{torch.cuda.get_device_name(device)} "
                    f"sm_{cap[0]}{cap[1]}")
    else:
        platform = device.type
    return {
        "jax": torch.__version__,
        "jaxlib": (f"cuda {torch.version.cuda} "
                   f"cudnn {torch.backends.cudnn.version()}"),
        "platform": platform,
        "tf32": {"cudnn": bool(torch.backends.cudnn.allow_tf32),
                 "matmul": bool(torch.backends.cuda.matmul.allow_tf32)},
    }


def _fmt(meta) -> str:
    shape = ",".join(str(int(d)) for d in meta.shape)
    return f"{str(meta.dtype).removeprefix('torch.')}[{shape}]"


def build_signature(program) -> Dict:
    """The calling-convention record of the manifest: the flat inputs'
    and outputs' dtypes and shapes."""
    sig: Dict = {"in": [], "out": []}
    try:
        nodes = {n.name: n for n in program.graph.nodes}
        sig["in"] = [_fmt(nodes[name].meta["val"])
                     for name in program.graph_signature.user_inputs]
        out = next(n for n in program.graph.nodes if n.op == "output")
        sig["out"] = [_fmt(a.meta["val"]) for a in out.args[0]
                      if hasattr(a, "meta") and "val" in a.meta]
    except Exception:  # noqa: BLE001 — the record is informative only
        pass
    return sig


# -- the store ------------------------------------------------------------

def key_digest(components: Dict) -> str:
    """Canonical-JSON sha256 over the component dict: the entry's name.
    Raises on non-JSON components: a key that cannot round-trip through
    the manifest cannot be verified on load."""
    blob = json.dumps(components, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


class AOTCache:
    """Content-addressed store of exported bucket programs.

    Layout: ``root/objects/<digest>/{manifest.json, executable.bin}``,
    where ``digest = sha256(canonical key json)`` and the blob is what
    ``torch.export.save`` writes. The engine builds each bucket once, and
    processes racing one digest resolve by atomic rename (the first insert
    wins).
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(str(root))
        self.objects = os.path.join(self.root, "objects")
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.last_miss = ""   # why the last load missed

    def entry_dir(self, components: Dict) -> str:
        return os.path.join(self.objects, key_digest(components))

    # -- load (never raises, never loads wrong) ---------------------------

    def load(self, components: Dict):
        """The verified load: an ``ExportedProgram``, or ``None`` on ANY
        verification failure. The checks run in trust order (manifest
        parse, format tag, verbatim key, blob hash) before
        ``torch.export.load`` reads a byte."""
        edir = self.entry_dir(components)
        if not os.path.isdir(edir):
            return self._miss("absent")
        # chaos surface: corrupt the artifact before the read...
        fault_file("aot.load", edir)
        try:
            # ...and raise inside the verification scope: both must read
            # as a clean miss
            fault_point("aot.load")
            with open(os.path.join(edir, _MANIFEST),
                      encoding="utf-8") as f:
                manifest = json.load(f)
            if manifest.get("format") != AOT_FORMAT:
                return self._miss("format skew")
            if manifest.get("key") != components:
                return self._miss("key mismatch")
            with open(os.path.join(edir, _BLOB), "rb") as f:
                blob = f.read()
            if hashlib.sha256(blob).hexdigest() != manifest.get("sha256"):
                return self._miss("blob hash mismatch")
            import torch
            import raft_tpu_torch.kernels  # noqa: F401  (the operators)

            program = torch.export.load(io.BytesIO(blob))
        except Exception as exc:  # noqa: BLE001 — any failure is a miss
            return self._miss(f"{type(exc).__name__}: {exc}")
        self.hits += 1
        return program

    def _miss(self, why: str):
        self.misses += 1
        self.last_miss = why
        return None

    # -- store (atomic, best-effort) --------------------------------------

    def store(self, components: Dict, program) -> Optional[str]:
        """Save ``program`` (an ``ExportedProgram``) under ``components``;
        returns the entry dir, or ``None`` when it cannot be saved or the
        write fails: the store accelerates, it never gates."""
        missing = REQUIRED_KEY_FIELDS - set(components)
        if missing:
            raise ValueError(
                f"aot cache key missing component(s) {sorted(missing)} "
                "— an incomplete key is a stale-load hazard")
        try:
            import torch

            buf = io.BytesIO()
            torch.export.save(program, buf)
            blob = buf.getvalue()
            manifest = {
                "format": AOT_FORMAT,
                "key": components,
                "sha256": hashlib.sha256(blob).hexdigest(),
                "blob_bytes": len(blob),
                "signature": build_signature(program),
            }
            final = self.entry_dir(components)
            if os.path.isdir(final):
                if self._entry_valid(final, components):
                    return final           # first insert already won
                shutil.rmtree(final, ignore_errors=True)
            os.makedirs(self.objects, exist_ok=True)
            tmp = tempfile.mkdtemp(prefix=".tmp-", dir=self.objects)
            with open(os.path.join(tmp, _BLOB), "wb") as f:
                f.write(blob)
            # manifest LAST: a torn write can only ever lose the
            # manifest, and an entry without one reads as a miss
            with open(os.path.join(tmp, _MANIFEST), "w",
                      encoding="utf-8") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
            try:
                os.rename(tmp, final)
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)   # racer won
            self.stores += 1
            return final
        except Exception:  # noqa: BLE001
            return None

    def _entry_valid(self, edir: str, components: Dict) -> bool:
        """Cheap integrity read (no load): the manifest parses, the key
        matches, the blob hash matches."""
        try:
            with open(os.path.join(edir, _MANIFEST),
                      encoding="utf-8") as f:
                manifest = json.load(f)
            if (manifest.get("format") != AOT_FORMAT
                    or manifest.get("key") != components):
                return False
            with open(os.path.join(edir, _BLOB), "rb") as f:
                blob = f.read()
            return hashlib.sha256(blob).hexdigest() == \
                manifest.get("sha256")
        except Exception:  # noqa: BLE001
            return False

    # -- GC (the store must not only grow) ---------------------------------

    def evict(self, max_bytes: Optional[int] = None,
              max_age_s: Optional[float] = None,
              weights: Optional[str] = None) -> Dict[str, int]:
        """Garbage-collect entries; returns ``{removed, removed_bytes,
        remaining, remaining_bytes}``. Three policies, in this order:

        - ``weights``: drop every entry whose key carries this weights
          fingerprint (the registry's retirement hook);
        - ``max_age_s``: drop entries whose manifest is older;
        - ``max_bytes``: then drop the OLDEST until the blobs fit (the
          newest entries, the ones a warm restart wants, survive).

        Torn entries (no manifest, bad JSON) read as the oldest garbage.
        Best-effort: an unremovable entry is skipped, never raised."""
        out = {"removed": 0, "removed_bytes": 0,
               "remaining": 0, "remaining_bytes": 0}
        if not os.path.isdir(self.objects):
            return out
        entries = []
        for name in sorted(os.listdir(self.objects)):
            edir = os.path.join(self.objects, name)
            if not os.path.isdir(edir) or name.startswith(".tmp"):
                continue
            manifest = None
            mpath = os.path.join(edir, _MANIFEST)
            try:
                with open(mpath, encoding="utf-8") as f:
                    manifest = json.load(f)
                size = int(manifest.get("blob_bytes", 0))
                mtime = os.path.getmtime(mpath)
            except Exception:  # noqa: BLE001 — torn entry: garbage
                size = sum(
                    os.path.getsize(os.path.join(edir, p))
                    for p in os.listdir(edir)
                    if os.path.isfile(os.path.join(edir, p)))
                mtime = 0.0      # oldest possible: first to go
            entries.append((edir, manifest, size, mtime))

        def _drop(entry) -> None:
            edir, _, size, _ = entry
            shutil.rmtree(edir, ignore_errors=True)
            if not os.path.isdir(edir):
                out["removed"] += 1
                out["removed_bytes"] += size

        keep = []
        for e in entries:
            key = (e[1] or {}).get("key") or {}
            if weights is not None and key.get("weights") == weights:
                _drop(e)
            else:
                keep.append(e)
        if max_age_s is not None:
            cutoff = time.time() - float(max_age_s)
            fresh = []
            for e in keep:
                if e[3] < cutoff:
                    _drop(e)
                else:
                    fresh.append(e)
            keep = fresh
        if max_bytes is not None:
            total = sum(e[2] for e in keep)
            for e in sorted(keep, key=lambda e: e[3]):   # oldest first
                if total <= max_bytes:
                    break
                before = out["removed"]
                _drop(e)
                if out["removed"] > before:
                    total -= e[2]
                    keep.remove(e)
        out["remaining"] = len(keep)
        out["remaining_bytes"] = sum(e[2] for e in keep)
        return out

    # -- fleet distribution ------------------------------------------------

    def push(self, transport, *, attempts: int = 4,
             base_s: float = 0.25, max_s: float = 8.0,
             rng=None, sleep=None) -> Dict[str, int]:
        """Ship every valid entry to a joining host over the transport.

        Per entry, one ``put_artifact`` call carrying the manifest bytes,
        the blob and the blob's sha256. Verification is end to end: the
        worker recomputes the hash before any byte lands in its store,
        and the reply echoes the digest this side checks again. A
        corruption in transit (the ``transport.send`` site) reads as a
        clean ``TransportError`` and the entry is re-pushed under
        ``utils/retry``'s jittered backoff, at most ``attempts`` tries
        per entry before the push (and the host's admission) fails. Torn
        or invalid local entries are skipped, as :meth:`load` would skip
        them. Returns ``{"entries", "bytes", "retries"}``."""
        from raft_tpu_torch.utils.retry import retry as _retry

        out = {"entries": 0, "bytes": 0, "retries": 0}
        if not os.path.isdir(self.objects):
            return out
        for name in sorted(os.listdir(self.objects)):
            edir = os.path.join(self.objects, name)
            mpath = os.path.join(edir, _MANIFEST)
            bpath = os.path.join(edir, _BLOB)
            if not (os.path.isdir(edir) and os.path.isfile(mpath)
                    and os.path.isfile(bpath)):
                continue
            try:
                with open(mpath, "rb") as f:
                    manifest_bytes = f.read()
                manifest = json.loads(manifest_bytes.decode("utf-8"))
                with open(bpath, "rb") as f:
                    blob = f.read()
            except Exception:  # noqa: BLE001 — torn entry: skip
                continue
            sha = hashlib.sha256(blob).hexdigest()
            if sha != manifest.get("sha256"):
                continue   # locally corrupt: a load miss, not pushable

            def _send(name=name, manifest_bytes=manifest_bytes,
                      blob=blob, sha=sha):
                reply = transport.call("put_artifact", {
                    "digest": name, "manifest": manifest_bytes,
                    "blob": blob, "sha256": sha})
                if reply.get("sha256") != sha:
                    raise RuntimeError(
                        f"artifact {name}: push ack digest mismatch")
                return reply

            kw = {"attempts": attempts, "base_s": base_s,
                  "max_s": max_s, "rng": rng,
                  "on_retry": lambda *a, **k: out.__setitem__(
                      "retries", out["retries"] + 1)}
            if sleep is not None:
                kw["sleep"] = sleep
            _retry(_send, **kw)
            out["entries"] += 1
            out["bytes"] += len(blob)
        return out

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "stores": self.stores}


def as_cache(aot_cache) -> Optional[AOTCache]:
    """``aot_cache=`` as the engine takes it: None, a directory path, or
    an :class:`AOTCache` (anything with ``load``)."""
    if aot_cache is None or hasattr(aot_cache, "load"):
        return aot_cache
    return AOTCache(aot_cache)

