"""One host of the fleet as a process: a
:class:`~raft_tpu_torch.serving.hosts.HostWorker` served over the socket
transport (:func:`~raft_tpu_torch.serving.transport.serve_forever`); the
port's counterpart of the JAX package's ``tests/host_worker.py``.

Two modes:

- ``--stub``: a deterministic numpy engine, with no model and no device;
  its flow is a pure function of the inputs, so a parent computes the
  exact expected output itself::

      python -m raft_tpu_torch.serving.host_worker --stub --port 0

- ``--weights W.pth --aot-root DIR``: a real ``RAFTEngine`` built LAZILY
  at ``prewarm``, after the parent's ``AOTCache.push`` has landed
  verified programs under ``DIR``, with ``aot_cache=DIR`` and
  ``precompile=True``: the joining host builds every bucket from a pushed
  program and traces nothing (the ``prewarm`` reply's ``compiles`` is 0).
  The engine's recipe (``--small`` and the route flags, ``--iters``,
  ``--envelope``, ``--wire``, ``--warm-start``, ``--tf32``) must be the
  parent's for its keys to match the pushed entries. Without
  ``--aot-root`` the engine has no store and captures its live module (a
  join to measure against). The engine runs on the card unless
  ``--device cpu``; a worker that finds no card exits non-zero (it never
  serves on the CPU unasked).

Prints ``PORT <n>`` on stdout once bound (``--port 0`` binds an ephemeral
port); the parent reads it to build its ``SocketTransport``. A drill
SIGKILLs this process mid-batch: there is no graceful shutdown, on
purpose.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from raft_tpu_torch.serving.hosts import HostWorker, require_plain
from raft_tpu_torch.serving.transport import serve_forever


def _pad8(x: int) -> int:
    return -(-x // 8) * 8


class StubEngine:
    """Deterministic engine for the scheduler: flow = the per-pixel (i1 -
    i2) of the first two channels, scaled, a pure function of the inputs,
    so any process (the parent's oracle, either host) gives bitwise the
    same output. ``infer_delay_s`` widens the in-flight window a kill
    drill aims at."""

    warm_start = False
    wire = "f32"

    def __init__(self, infer_delay_s: float = 0.0):
        self.infer_delay_s = float(infer_delay_s)
        self._compiled = {}

    def bucket_capacity(self, h, w, kind="plain"):
        require_plain(kind)
        fits = [s[0] for s in self._compiled
                if s[1] == _pad8(h) and s[2] == _pad8(w)]
        return max(fits) if fits else None

    def ensure_bucket(self, b, h, w, kind="plain"):
        require_plain(kind)
        shape = (b, _pad8(h), _pad8(w))
        self._compiled[shape] = object()
        return shape

    def route_bucket(self, b, h, w, kind="plain"):
        require_plain(kind)
        return (b, _pad8(h), _pad8(w))

    def drop_bucket(self, shape, kind="plain"):
        require_plain(kind)
        return self._compiled.pop(shape, None) is not None

    def executable_count(self):
        return len(self._compiled)

    def infer_batch(self, i1, i2, **kw):
        if self.infer_delay_s:
            time.sleep(self.infer_delay_s)
        i1 = np.asarray(i1, np.float32)
        i2 = np.asarray(i2, np.float32)
        return ((i1 - i2)[..., :2] * 0.125).astype(np.float32)


def set_tf32(mode: str) -> None:
    """The process's TF32 flags (part of every program-store key):
    ``off``, ``cudnn`` (convolutions only; torch's defaults) or ``all``."""
    import torch

    torch.backends.cudnn.allow_tf32 = mode in ("cudnn", "all")
    torch.backends.cuda.matmul.allow_tf32 = mode == "all"


def _real_factory(args):
    def build():
        from raft_tpu_torch.cli._args import corr_overrides
        from raft_tpu_torch.config import RAFTConfig
        from raft_tpu_torch.serving.engine import RAFTEngine
        from raft_tpu_torch.tools.convert import load_weights

        cfg = RAFTConfig(small=args.small, **corr_overrides(args))
        model = load_weights(args.weights, cfg)
        # precompile over the envelope: with the pushed programs in place
        # every build is a store hit, pinned by the prewarm reply's
        # compiles == 0
        envelope = [tuple(int(v) for v in b.split("x"))
                    for b in args.envelope.split(",")]
        return RAFTEngine(model, cfg, iters=args.iters, envelope=envelope,
                          precompile=True, wire=args.wire,
                          warm_start=args.warm_start,
                          aot_cache=args.aot_root, device=args.device)
    return build


def main(argv=None):
    from raft_tpu_torch.cli._args import add_corr_args

    ap = argparse.ArgumentParser(description="one host of the serving "
                                             "fleet, over a socket")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--stub", action="store_true",
                    help="the deterministic numpy engine (no model)")
    ap.add_argument("--infer-delay-s", type=float, default=0.0)
    ap.add_argument("--weights",
                    help=".pth or .msgpack weights (real mode)")
    ap.add_argument("--aot-root", help="this host's program store")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--envelope", default="1x32x32", metavar="BxHxW,...",
                    help="the engine's buckets")
    ap.add_argument("--wire", default="f32", choices=["f32", "u8"])
    ap.add_argument("--warm-start", action="store_true")
    ap.add_argument("--tf32", default="cudnn",
                    choices=["off", "cudnn", "all"],
                    help="TF32 flags of this process (default: torch's, "
                         "convolutions only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless 'cpu' is asked for")
    add_corr_args(ap)
    args = ap.parse_args(argv)

    startup = {}
    if args.stub:
        worker = HostWorker(StubEngine(args.infer_delay_s),
                            aot_root=args.aot_root)
    else:
        if not args.weights:
            ap.error("real mode needs --weights")
        import torch

        set_tf32(args.tf32)
        if args.device != "cpu":
            if not torch.cuda.is_available():
                print("host_worker: no CUDA device (pass --device cpu to "
                      "serve on the CPU)", file=sys.stderr, flush=True)
                raise SystemExit(2)
            t0 = time.perf_counter()
            torch.zeros(1, device=args.device)
            torch.cuda.synchronize(args.device)
            startup["cuda_init_s"] = time.perf_counter() - t0
        worker = HostWorker(engine_factory=_real_factory(args),
                            aot_root=args.aot_root)
    worker.startup = startup
    serve_forever(args.port, worker, ready_fh=sys.stdout)


if __name__ == "__main__":
    main()
