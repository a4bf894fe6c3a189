"""Test-mode forward, validators and leaderboard submission writers, port of
``raft_tpu/evaluation/evaluate.py``.

The metric math is the JAX package's (the reference's ``evaluate.py``): EPE
and 1/3/5 px inlier rates (evaluate.py:118-124), KITTI F1-all = mean over
valid pixels of (epe > 3 ∧ epe/‖gt‖ > 0.05) (evaluate.py:148-163), and the
Sintel warm-start submission through host-side forward interpolation
(evaluate.py:22-50). Where the JAX validators take flax variables, these
take a ``RAFT`` module built for ``config``; they run on the card unless
``device="cpu"`` is passed.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from raft_tpu_torch.config import ITERS_EVAL, RAFTConfig
from raft_tpu_torch.data import datasets as ds
from raft_tpu_torch.data import frame_utils
from raft_tpu_torch.ops.interp import forward_interpolate
from raft_tpu_torch.ops.padding import InputPadder


def resolve_device(device: Optional[str] = "cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises when CUDA is asked for and there is none — an entry
    point never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: raft_tpu_torch runs on the GPU unless asked for "
            "the CPU (pass device='cpu', or --device cpu on the command line)")
    return dev


def make_forward(config: RAFTConfig, iters: int, device: str = "cuda"):
    """Test-mode forward on ``device``: ``fwd(model, image1, image2)`` and
    ``fwd_init(model, image1, image2, flow_init)`` return ``(flow_low,
    flow_up)``. ``model`` is a ``RAFT`` built for ``config``; each call
    moves it to the device in place (a no-op once it is there). Images are
    (B, H, W, 3) numpy arrays or tensors with H, W % 8 == 0."""
    dev = resolve_device(device)

    def _prep(model):
        if model.config != config:
            raise ValueError("model was built for another RAFTConfig")
        return model.to(dev).eval()

    def _as_tensor(a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(dev, torch.float32)

    @torch.no_grad()
    def fwd(model, image1, image2):
        return _prep(model)(_as_tensor(image1), _as_tensor(image2),
                            iters=iters, test_mode=True)

    @torch.no_grad()
    def fwd_init(model, image1, image2, flow_init):
        return _prep(model)(_as_tensor(image1), _as_tensor(image2),
                            iters=iters, flow_init=_as_tensor(flow_init),
                            test_mode=True)

    return fwd, fwd_init


def _to_device_pair(img1: np.ndarray, img2: np.ndarray, mode: str,
                    bucket: Optional[int] = None, device: str = "cuda"):
    """numpy HWC frames -> padded (1, H, W, 3) float32 tensors on ``device``
    + padder + the ÷8-padded size.

    ``bucket`` additionally edge-pads H/W up to the next multiple, so
    datasets with a handful of distinct sizes (KITTI: ~5) share one padded
    shape, as in the JAX package. There it saves compiles; eager PyTorch
    compiles nothing, so here it saves nothing and costs pixels (a KITTI
    frame runs at 384x1280 instead of 376x1248, 5% more): it is kept only
    so that the validators' numbers equal the JAX package's
    (``tests/test_torch_eval.py`` holds them to it). Returns ``(i1, i2,
    padder, crop_hw)``; crop the model's output to ``crop_hw`` before
    ``padder.unpad``. The fill shifts the encoders' instance-norm
    statistics, so pointwise flow moves with it; pass ``bucket=None`` for
    exact reference padding.
    """
    dev = resolve_device(device)
    i1 = torch.from_numpy(np.asarray(img1, np.float32))[None].to(dev)
    i2 = torch.from_numpy(np.asarray(img2, np.float32))[None].to(dev)
    padder = InputPadder(i1.shape, mode=mode)
    i1, i2 = padder.pad(i1, i2)
    hp, wp = i1.shape[1], i1.shape[2]
    if bucket:
        hb = -(-hp // bucket) * bucket
        wb = -(-wp // bucket) * bucket
        if (hb, wb) != (hp, wp):
            i1, i2 = (F.pad(x.permute(0, 3, 1, 2), (0, wb - wp, 0, hb - hp),
                            mode="replicate").permute(0, 2, 3, 1)
                      for x in (i1, i2))
    return i1, i2, padder, (hp, wp)


def _crop(flow: torch.Tensor, crop_hw) -> torch.Tensor:
    """Undo bucket fill on a (B, H, W, C) output (no-op when unbucketed)."""
    return flow[:, :crop_hw[0], :crop_hw[1], :]


def _batched_eval(val, fwd, model, mode: str, batch_size: int):
    """Iterate a uniform-size dataset in padded batches of ``batch_size``
    pairs, yielding ``(flow_pred, flow_gt)`` per image. The trailing partial
    batch is padded by repeating its last sample (extra outputs dropped), so
    every forward has one shape; EPE is still computed per image."""
    n = len(val)
    for start in range(0, n, batch_size):
        items = [val[i] for i in range(start, min(start + batch_size, n))]
        count = len(items)
        while len(items) < batch_size:  # repeat-pad the trailing batch
            items.append(items[-1])
        img1 = torch.from_numpy(np.stack([it[0] for it in items]))
        img2 = torch.from_numpy(np.stack([it[1] for it in items]))
        padder = InputPadder(img1.shape, mode=mode)
        _, flow_pr = fwd(model, *padder.pad(img1, img2))
        flow = padder.unpad(flow_pr).cpu().numpy()
        for j in range(count):
            yield flow[j], items[j][2]


# FileNotFoundError on an unstaged dataset dir
_require_data = ds.require_nonempty


def validate_chairs(model, config: RAFTConfig,
                    iters: int = ITERS_EVAL["chairs"],
                    data_root: str = "datasets", batch_size: int = 4,
                    device: str = "cuda") -> Dict[str, float]:
    """FlyingChairs validation split EPE (evaluate.py:75-92)."""
    fwd, _ = make_forward(config, iters, device)
    root = osp.join(data_root, "FlyingChairs_release/data")
    val = ds.FlyingChairs(split="validation", root=root)
    _require_data(val, "FlyingChairs validation", root)
    epe_list = []
    for flow, flow_gt in _batched_eval(val, fwd, model, "sintel",
                                       batch_size):
        epe = np.sqrt(np.sum((flow - flow_gt) ** 2, -1))
        epe_list.append(epe.reshape(-1))
    epe = float(np.mean(np.concatenate(epe_list)))
    print(f"Validation Chairs EPE: {epe:f}")
    return {"chairs": epe}


def validate_sintel(model, config: RAFTConfig,
                    iters: int = ITERS_EVAL["sintel"],
                    data_root: str = "datasets", batch_size: int = 4,
                    device: str = "cuda") -> Dict[str, float]:
    """Sintel train-split validation (evaluate.py:96-127)."""
    fwd, _ = make_forward(config, iters, device)
    results = {}
    for dstype in ["clean", "final"]:
        val = ds.MpiSintel(split="training", root=osp.join(data_root, "Sintel"),
                           dstype=dstype)
        _require_data(val, f"Sintel training/{dstype}",
                      osp.join(data_root, "Sintel"))
        epe_list = []
        for flow, flow_gt in _batched_eval(val, fwd, model, "sintel",
                                           batch_size):
            epe = np.sqrt(np.sum((flow - flow_gt) ** 2, -1))
            epe_list.append(epe.reshape(-1))

        epe_all = np.concatenate(epe_list)
        print("Validation (%s) EPE: %f, 1px: %f, 3px: %f, 5px: %f" % (
            dstype, np.mean(epe_all), np.mean(epe_all < 1),
            np.mean(epe_all < 3), np.mean(epe_all < 5)))
        # the reference reports the mean of per-image means (evaluate.py:125)
        results[dstype] = float(np.mean([e.mean() for e in epe_list]))
    return results


def validate_kitti(model, config: RAFTConfig,
                   iters: int = ITERS_EVAL["kitti"],
                   data_root: str = "datasets",
                   shape_bucket: Optional[int] = 64,
                   device: str = "cuda") -> Dict[str, float]:
    """KITTI-15 train-split validation with F1-all (evaluate.py:131-166).
    ``shape_bucket`` routes KITTI's few frame sizes through one padded
    shape, as the JAX package does, so that the numbers equal its; it buys
    nothing on the port (see ``_to_device_pair``). ``None`` pads as the
    reference does."""
    fwd, _ = make_forward(config, iters, device)
    val = ds.KITTI(split="training", root=osp.join(data_root, "KITTI"))
    _require_data(val, "KITTI training", osp.join(data_root, "KITTI"))
    out_list, epe_list = [], []
    for i in range(len(val)):
        img1, img2, flow_gt, valid_gt = val[i]
        i1, i2, padder, crop_hw = _to_device_pair(img1, img2, "kitti",
                                                  shape_bucket, device)
        _, flow_pr = fwd(model, i1, i2)
        flow = padder.unpad(_crop(flow_pr, crop_hw))[0].cpu().numpy()

        epe = np.sqrt(np.sum((flow - flow_gt) ** 2, -1)).reshape(-1)
        mag = np.sqrt(np.sum(flow_gt ** 2, -1)).reshape(-1)
        val_mask = valid_gt.reshape(-1) >= 0.5

        out = ((epe > 3.0) & ((epe / np.maximum(mag, 1e-12)) > 0.05)
               ).astype(np.float32)
        epe_list.append(epe[val_mask].mean())
        out_list.append(out[val_mask])

    epe = float(np.mean(np.array(epe_list)))
    f1 = float(100 * np.mean(np.concatenate(out_list)))
    print(f"Validation KITTI: {epe:f}, {f1:f}")
    return {"kitti-epe": epe, "kitti-f1": f1}


def create_sintel_submission(model, config: RAFTConfig, iters: int = 32,
                             warm_start: bool = False,
                             output_path: str = "sintel_submission",
                             data_root: str = "datasets",
                             device: str = "cuda") -> None:
    """Sintel leaderboard writer with optional warm start (evaluate.py:22-50):
    each pair after the first of a scene starts from the previous pair's
    low-res flow, forward-interpolated on the host."""
    fwd, fwd_init = make_forward(config, iters, device)
    for dstype in ["clean", "final"]:
        test = ds.MpiSintel(split="test", aug_params=None,
                            root=osp.join(data_root, "Sintel"), dstype=dstype)
        _require_data(test, f"Sintel test/{dstype}",
                      osp.join(data_root, "Sintel"))
        flow_prev, sequence_prev = None, None
        for test_id in range(len(test)):
            image1, image2, (sequence, frame) = test[test_id]
            if sequence != sequence_prev:
                flow_prev = None

            i1, i2, padder, _ = _to_device_pair(image1, image2, "sintel",
                                                device=device)
            if flow_prev is None:
                flow_low, flow_pr = fwd(model, i1, i2)
            else:
                flow_low, flow_pr = fwd_init(model, i1, i2, flow_prev[None])
            flow = padder.unpad(flow_pr)[0].cpu().numpy()

            if warm_start:
                flow_prev = forward_interpolate(flow_low[0].cpu().numpy())

            output_dir = osp.join(output_path, dstype, sequence)
            os.makedirs(output_dir, exist_ok=True)
            frame_utils.write_flow(
                osp.join(output_dir, "frame%04d.flo" % (frame + 1)), flow)
            sequence_prev = sequence


def create_kitti_submission(model, config: RAFTConfig, iters: int = 24,
                            output_path: str = "kitti_submission",
                            data_root: str = "datasets",
                            shape_bucket: Optional[int] = None,
                            device: str = "cuda") -> None:
    """KITTI leaderboard writer (evaluate.py:53-71); unbucketed by default,
    so submitted flows get the reference's padding."""
    fwd, _ = make_forward(config, iters, device)
    test = ds.KITTI(split="testing", aug_params=None,
                    root=osp.join(data_root, "KITTI"))
    _require_data(test, "KITTI testing", osp.join(data_root, "KITTI"))
    os.makedirs(output_path, exist_ok=True)
    for test_id in range(len(test)):
        image1, image2, (frame_id,) = test[test_id]
        i1, i2, padder, crop_hw = _to_device_pair(image1, image2, "kitti",
                                                  shape_bucket, device)
        _, flow_pr = fwd(model, i1, i2)
        flow = padder.unpad(_crop(flow_pr, crop_hw))[0].cpu().numpy()
        frame_utils.write_flow_kitti(osp.join(output_path, frame_id), flow)


VALIDATORS = {
    "chairs": validate_chairs,
    "sintel": validate_sintel,
    "kitti": validate_kitti,
}
