from raft_tpu_torch.models.corr import (  # noqa: F401
    AlternateCorrBlock,
    all_pairs_correlation,
    alt_corr_lookup,
    build_corr_pyramid,
    corr_lookup,
    corr_lookup_gather,
)
from raft_tpu_torch.models.encoders import BasicEncoder, SmallEncoder  # noqa: F401
from raft_tpu_torch.models.layers import (  # noqa: F401
    BottleneckBlock,
    ResidualBlock,
    norm_layer,
)
from raft_tpu_torch.models.raft import RAFT  # noqa: F401
from raft_tpu_torch.models.update import (  # noqa: F401
    BasicUpdateBlock,
    ConvGRU,
    FlowHead,
    SepConvGRU,
    SmallUpdateBlock,
)
