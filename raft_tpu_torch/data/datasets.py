"""Flow datasets for evaluation, port of ``raft_tpu/data/datasets.py``.

Pure-Python indexers yielding numpy NHWC samples: img1/img2 (H, W, 3)
float32, flow (H, W, 2) float32, valid (H, W) float32; test splits yield
(img1, img2, extra_info). ``MpiSintel``, ``FlyingChairs`` and ``KITTI`` read
the datasets' on-disk layouts through ``data.frame_utils``.

FlyingChairs needs the upstream ``chairs_split.txt`` (1=train, 2=val). A
copy is bundled at ``raft_tpu_torch/data/chairs_split.txt`` and found after
the working directory and the dataset root are searched; pass
``split_file`` to override.

Training's part of the module waits for the port's data pipeline (ROADMAP
M13) and raises ``NotImplementedError`` naming it: augmentation
(``aug_params``), ``FlyingThings3D``, ``HD1K``, ``ConcatDataset`` and
``fetch_dataset``.
"""

from __future__ import annotations

import os
import os.path as osp
from glob import glob
from typing import Optional

import numpy as np

from raft_tpu_torch.data import frame_utils


def _training_waits(what: str):
    raise NotImplementedError(
        f"{what} belongs to training's data pipeline, ROADMAP M13 of the port")


class FlowDataset:
    def __init__(self, aug_params=None, sparse: bool = False):
        if aug_params is not None:
            _training_waits("augmentation (aug_params)")
        self.sparse = sparse
        self.is_test = False
        self.flow_list = []
        self.image_list = []
        self.extra_info = []

    def __getitem__(self, index):
        if self.is_test:
            img1 = frame_utils.read_gen(
                self.image_list[index][0]).astype(np.uint8)[..., :3]
            img2 = frame_utils.read_gen(
                self.image_list[index][1]).astype(np.uint8)[..., :3]
            return (img1.astype(np.float32), img2.astype(np.float32),
                    self.extra_info[index])

        index = index % len(self.image_list)
        valid = None
        if self.sparse:
            flow, valid = frame_utils.read_flow_kitti(self.flow_list[index])
        else:
            flow = frame_utils.read_gen(self.flow_list[index])

        img1 = frame_utils.read_gen(self.image_list[index][0]).astype(np.uint8)
        img2 = frame_utils.read_gen(self.image_list[index][1]).astype(np.uint8)
        flow = np.asarray(flow, np.float32)

        if img1.ndim == 2:  # grayscale
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        else:
            img1 = img1[..., :3]
            img2 = img2[..., :3]

        if valid is None:
            # synthetic-data validity cutoff (datasets.py:88)
            valid = ((np.abs(flow[..., 0]) < 1000)
                     & (np.abs(flow[..., 1]) < 1000))
        return (img1.astype(np.float32), img2.astype(np.float32), flow,
                np.asarray(valid, np.float32))

    def __len__(self):
        return len(self.image_list)


def require_nonempty(dataset, name: str, root: str) -> None:
    """Dataset scans glob the disk and come back empty when the data is not
    staged; surface that as FileNotFoundError so callers can skip cleanly
    instead of crashing on an empty reduction downstream."""
    if len(dataset) == 0:
        raise FileNotFoundError(
            f"{name}: no samples found under '{root}' — dataset not staged")


class MpiSintel(FlowDataset):
    def __init__(self, aug_params=None, split="training",
                 root="datasets/Sintel", dstype="clean"):
        super().__init__(aug_params)
        flow_root = osp.join(root, split, "flow")
        image_root = osp.join(root, split, dstype)

        if split == "test":
            self.is_test = True

        if osp.isdir(image_root):
            for scene in sorted(os.listdir(image_root)):
                image_list = sorted(glob(osp.join(image_root, scene, "*.png")))
                for i in range(len(image_list) - 1):
                    self.image_list += [[image_list[i], image_list[i + 1]]]
                    self.extra_info += [(scene, i)]
                if split != "test":
                    self.flow_list += sorted(
                        glob(osp.join(flow_root, scene, "*.flo")))


class FlyingChairs(FlowDataset):
    def __init__(self, aug_params=None, split="train",
                 root="datasets/FlyingChairs_release/data",
                 split_file: Optional[str] = None):
        super().__init__(aug_params)

        images = sorted(glob(osp.join(root, "*.ppm")))
        flows = sorted(glob(osp.join(root, "*.flo")))
        if not flows:
            return
        if len(images) // 2 != len(flows):
            raise ValueError(f"{root}: {len(images)} frames for {len(flows)} "
                             "flows; want two frames per flow")

        if split_file is None:
            # bundled manifest last: explicit/dataset-local copies win
            for cand in ("chairs_split.txt",
                         osp.join(root, "chairs_split.txt"),
                         osp.join(root, "..", "chairs_split.txt"),
                         osp.join(osp.dirname(osp.abspath(__file__)),
                                  "chairs_split.txt")):
                if osp.exists(cand):
                    split_file = cand
                    break
        split_list = np.loadtxt(split_file, dtype=np.int32)
        for i in range(len(flows)):
            xid = split_list[i]
            if (split == "training" and xid == 1) or \
                    (split == "validation" and xid == 2):
                self.flow_list += [flows[i]]
                self.image_list += [[images[2 * i], images[2 * i + 1]]]


class KITTI(FlowDataset):
    def __init__(self, aug_params=None, split="training",
                 root="datasets/KITTI"):
        super().__init__(aug_params, sparse=True)
        if split == "testing":
            self.is_test = True

        root = osp.join(root, split)
        images1 = sorted(glob(osp.join(root, "image_2/*_10.png")))
        images2 = sorted(glob(osp.join(root, "image_2/*_11.png")))

        for img1, img2 in zip(images1, images2):
            frame_id = img1.split("/")[-1]
            self.extra_info += [[frame_id]]
            self.image_list += [[img1, img2]]

        if split == "training":
            self.flow_list = sorted(glob(osp.join(root, "flow_occ/*_10.png")))


class FlyingThings3D(FlowDataset):
    def __init__(self, *args, **kwargs):
        _training_waits("FlyingThings3D")


class HD1K(FlowDataset):
    def __init__(self, *args, **kwargs):
        _training_waits("HD1K")


class ConcatDataset:
    def __init__(self, *args, **kwargs):
        _training_waits("ConcatDataset (the stage mixes)")


def fetch_dataset(*args, **kwargs):
    _training_waits("fetch_dataset (the stage-keyed training mix)")
