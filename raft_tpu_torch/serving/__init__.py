"""Serving, port of ``raft_tpu/serving``'s engine layer (ROADMAP M10).

``engine.py`` is the shape-bucketed engine (one captured CUDA graph per
bucket on the card, the eager forward on the CPU), ``ragged.py`` the masked
correlation of ragged batches, ``export.py`` the ``torch.export`` path. The
host layers above the engine (scheduler, sessions, registry, fleet) are
ROADMAP M11.
"""

from raft_tpu_torch.serving.engine import (SHAPE_ENVELOPE_LINUX,
                                           SHAPE_ENVELOPE_WINDOWS,
                                           PendingBatch, RaggedPendingBatch,
                                           RAFTEngine, StaleFeatureError)
from raft_tpu_torch.serving.export import (export_program, load_program,
                                           make_serving_fn)
from raft_tpu_torch.serving.ragged import (RaggedDescriptor,
                                           build_corr_pyramid_ragged,
                                           corr_lookup_ragged,
                                           make_descriptor, mask_features)

__all__ = ["RAFTEngine", "PendingBatch", "RaggedPendingBatch",
           "StaleFeatureError", "SHAPE_ENVELOPE_LINUX",
           "SHAPE_ENVELOPE_WINDOWS", "export_program", "load_program",
           "make_serving_fn", "RaggedDescriptor",
           "make_descriptor", "mask_features", "build_corr_pyramid_ragged",
           "corr_lookup_ragged"]
