from raft_tpu_torch.evaluation.evaluate import (  # noqa: F401
    VALIDATORS,
    create_kitti_submission,
    create_sintel_submission,
    make_forward,
    resolve_device,
    validate_chairs,
    validate_kitti,
    validate_sintel,
)
