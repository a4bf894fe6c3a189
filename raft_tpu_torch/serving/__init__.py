"""Serving, port of ``raft_tpu/serving`` (ROADMAP M10 and M11).

The engine layer: ``engine.py`` is the shape-bucketed engine (one captured
CUDA graph per bucket on the card, the eager forward on the CPU),
``ragged.py`` the masked correlation of ragged batches, ``export.py`` the
``torch.export`` path.

The one-model front end above it: an async micro-batching scheduler with
deadlines, backpressure and priority classes (``scheduler.py``), per-stream
warm-start video sessions (``session.py``), the cross-frame feature-cache
pool (``feature_cache.py``), the resilience layer (``resilience.py``:
dispatch watchdog with quarantine-and-replace and per-bucket circuit
breakers), the metrics surface (``metrics.py``), request-scoped tracing
(``trace.py``, read back by ``raft_tpu_torch.cli.serve_trace``) and the
record schemas (``schema.py``).

Above it, several models on one card: the registry (``registry.py``:
versioned engines per named model, canary rollout by a deterministic
request hash, promote and rollback with zero stranded futures), the SLO
guardian that bakes a canary and promotes or rolls it back, and the
registry-wide admission budget (``guardian.py``); and the scheduler's
replica fleet, N engines on the card behind one queue.

Across processes: the program store (``aot.py``: each bucket's exported
program behind a content-addressed, sha256-verified store that a joining
process loads instead of tracing), the transport (``transport.py``:
loopback and socket, one wire protocol with the JAX package's), and the
host fleet (``hosts.py``: workers that take no traffic until their pushed
programs verify, heartbeats, failover and rejoin; ``host_worker.py`` is a
worker's process).

Beside them, ``video.py`` renders flows, under their frames, into an MJPG
AVI with the port's own JPEG codec.
"""

from raft_tpu_torch.serving.aot import AOTCache, key_digest
from raft_tpu_torch.serving.engine import (SHAPE_ENVELOPE_LINUX,
                                           SHAPE_ENVELOPE_WINDOWS,
                                           PendingBatch, RAFTEngine,
                                           StaleFeatureError)
from raft_tpu_torch.serving.export import (export_program, load_program,
                                           make_serving_fn)
from raft_tpu_torch.serving.feature_cache import (FeatureCacheMiss,
                                                  FeatureCachePool)
from raft_tpu_torch.serving.futures import settle_future
from raft_tpu_torch.serving.guardian import (AdmissionBudget,
                                             GuardianPolicy, SLOGuardian)
from raft_tpu_torch.serving.hosts import (HostDead, HostFleet, HostWorker,
                                          RemoteEngine)
from raft_tpu_torch.serving.metrics import LatencyHistogram, ServingMetrics
from raft_tpu_torch.serving.registry import (DeployError, ModelRegistry,
                                             RolloutInProgress,
                                             UnknownModel)
from raft_tpu_torch.serving.ragged import (RaggedDescriptor,
                                           build_corr_pyramid_ragged,
                                           corr_lookup_ragged,
                                           make_descriptor, mask_features)
from raft_tpu_torch.serving.resilience import (CircuitBreaker, CircuitOpen,
                                               DispatchExecutor,
                                               DispatchWedged)
from raft_tpu_torch.serving.scheduler import (PRIORITY_BATCH,
                                              PRIORITY_INTERACTIVE,
                                              BackpressureError,
                                              DeadlineExceeded,
                                              MicroBatchScheduler,
                                              SchedulerClosed, ServeResult)
from raft_tpu_torch.serving.session import VideoSession
from raft_tpu_torch.serving.trace import TraceLedger
from raft_tpu_torch.serving.transport import (LoopbackTransport,
                                              SocketTransport,
                                              TransportError)
from raft_tpu_torch.serving.video import optical_flow_visualize

__all__ = ["RAFTEngine", "PendingBatch", "StaleFeatureError",
           "SHAPE_ENVELOPE_LINUX", "SHAPE_ENVELOPE_WINDOWS",
           "export_program", "load_program", "make_serving_fn",
           "RaggedDescriptor",
           "make_descriptor", "mask_features", "build_corr_pyramid_ragged",
           "corr_lookup_ragged", "MicroBatchScheduler", "BackpressureError",
           "DeadlineExceeded", "SchedulerClosed", "ServeResult",
           "VideoSession", "ServingMetrics", "LatencyHistogram",
           "CircuitBreaker", "CircuitOpen", "DispatchExecutor",
           "DispatchWedged", "PRIORITY_INTERACTIVE", "PRIORITY_BATCH",
           "settle_future", "FeatureCachePool", "FeatureCacheMiss",
           "TraceLedger", "ModelRegistry", "DeployError",
           "RolloutInProgress", "UnknownModel", "SLOGuardian",
           "GuardianPolicy", "AdmissionBudget", "AOTCache", "key_digest",
           "HostFleet", "HostWorker", "RemoteEngine", "HostDead",
           "LoopbackTransport", "SocketTransport", "TransportError",
           "optical_flow_visualize"]
