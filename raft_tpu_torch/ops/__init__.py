from raft_tpu_torch.ops.flow_ops import (  # noqa: F401
    convex_upsample,
    initialize_flow,
    resize_bilinear_align_corners,
    upflow8,
)
from raft_tpu_torch.ops.padding import InputPadder, pad_amounts  # noqa: F401
from raft_tpu_torch.ops.pooling import avg_pool2x2  # noqa: F401
from raft_tpu_torch.ops.sampling import (  # noqa: F401
    bilinear_sampler,
    coords_grid,
    grid_sample_nhwc,
)
