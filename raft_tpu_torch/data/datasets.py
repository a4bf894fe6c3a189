"""Flow datasets for evaluation, port of ``raft_tpu/data/datasets.py``.

Pure-Python indexers yielding numpy NHWC samples: img1/img2 (H, W, 3)
float32, flow (H, W, 2) float32, valid (H, W) float32; test splits yield
(img1, img2, extra_info). ``MpiSintel``, ``FlyingChairs`` and ``KITTI`` read
the datasets' on-disk layouts through ``data.frame_utils``.

FlyingChairs needs the upstream ``chairs_split.txt`` (1=train, 2=val). A
copy is bundled at ``raft_tpu_torch/data/chairs_split.txt`` and found after
the working directory and the dataset root are searched; pass
``split_file`` to override.

Training's part: ``aug_params`` selects the port's numpy augmentors
(``data.augmentor``), ``FlyingThings3D`` reads ``.pfm`` flow, ``HD1K`` and
``KITTI`` sparse 16-bit PNG flow, and :func:`fetch_dataset` assembles each
stage's mix with the same list-replication arithmetic (``n * dataset``,
datasets.py:93-96 of the reference) and :class:`ConcatDataset`, e.g. the
sintel stage's 100·sc + 100·sf + 200·k + 5·h + things (datasets.py:218-221).
"""

from __future__ import annotations

import os
import os.path as osp
from glob import glob
from typing import Optional

import numpy as np

from raft_tpu_torch.data import frame_utils
from raft_tpu_torch.data.augmentor import FlowAugmentor, SparseFlowAugmentor


class FlowDataset:
    def __init__(self, aug_params=None, sparse: bool = False):
        self.augmentor = None
        if aug_params is not None:
            self.augmentor = (SparseFlowAugmentor(**aug_params) if sparse
                              else FlowAugmentor(**aug_params))
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

        if self.augmentor is not None:
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(img1, img2, flow,
                                                         valid)
            else:
                img1, img2, flow = self.augmentor(img1, img2, flow)
        flow = flow.astype(np.float32)

        if valid is None:
            # synthetic-data validity cutoff (datasets.py:88)
            valid = ((np.abs(flow[..., 0]) < 1000)
                     & (np.abs(flow[..., 1]) < 1000))
        return (img1.astype(np.float32), img2.astype(np.float32), flow,
                np.asarray(valid, np.float32))

    def reseed(self, seed: int):
        if self.augmentor is not None:
            self.augmentor.reseed(seed)

    def __rmul__(self, v: int):
        self.flow_list = v * self.flow_list
        self.image_list = v * self.image_list
        return self

    def __add__(self, other):
        return ConcatDataset([self, other])

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


class ConcatDataset:
    """The stage mixes' concatenation (torch's ``ConcatDataset``): nested
    concatenations flatten, and ``reseed(seed)`` gives member i
    ``seed + i``."""

    def __init__(self, datasets):
        flat = []
        for d in datasets:
            flat.extend(d.datasets if isinstance(d, ConcatDataset) else [d])
        self.datasets = flat
        self.cum = np.cumsum([len(d) for d in flat])

    def reseed(self, seed: int):
        for i, d in enumerate(self.datasets):
            d.reseed(seed + i)

    def __len__(self):
        return int(self.cum[-1])

    def __add__(self, other):
        return ConcatDataset([self, other])

    def __radd__(self, other):
        return ConcatDataset([other, self])

    def __getitem__(self, index):
        ds = int(np.searchsorted(self.cum, index, side="right"))
        prev = 0 if ds == 0 else int(self.cum[ds - 1])
        return self.datasets[ds][index - prev]


class FlyingThings3D(FlowDataset):
    def __init__(self, aug_params=None, root="datasets/FlyingThings3D",
                 dstype="frames_cleanpass"):
        super().__init__(aug_params)

        for cam in ["left"]:
            for direction in ["into_future", "into_past"]:
                image_dirs = sorted(glob(osp.join(root, dstype, "TRAIN/*/*")))
                image_dirs = sorted([osp.join(f, cam) for f in image_dirs])
                flow_dirs = sorted(
                    glob(osp.join(root, "optical_flow/TRAIN/*/*")))
                flow_dirs = sorted(
                    [osp.join(f, direction, cam) for f in flow_dirs])

                for idir, fdir in zip(image_dirs, flow_dirs):
                    images = sorted(glob(osp.join(idir, "*.png")))
                    flows = sorted(glob(osp.join(fdir, "*.pfm")))
                    for i in range(len(flows) - 1):
                        if direction == "into_future":
                            self.image_list += [[images[i], images[i + 1]]]
                            self.flow_list += [flows[i]]
                        else:
                            self.image_list += [[images[i + 1], images[i]]]
                            self.flow_list += [flows[i + 1]]


class HD1K(FlowDataset):
    def __init__(self, aug_params=None, root="datasets/HD1k"):
        super().__init__(aug_params, sparse=True)

        seq_ix = 0
        while True:
            flows = sorted(glob(osp.join(
                root, "hd1k_flow_gt", "flow_occ/%06d_*.png" % seq_ix)))
            images = sorted(glob(osp.join(
                root, "hd1k_input", "image_2/%06d_*.png" % seq_ix)))
            if len(flows) == 0:
                break
            for i in range(len(flows) - 1):
                self.flow_list += [flows[i]]
                self.image_list += [[images[i], images[i + 1]]]
            seq_ix += 1


def fetch_dataset(stage: str, image_size, data_root: str = "datasets",
                  train_ds: str = "C+T+K+S+H"):
    """The stage-keyed training mix (datasets.py:199-228). Raises
    ``FileNotFoundError`` when it has no sample (the data is not staged)."""
    mix = _fetch_dataset(stage, image_size, data_root, train_ds)
    require_nonempty(mix, f"stage {stage!r}", data_root)
    return mix


def _fetch_dataset(stage: str, image_size, data_root: str, train_ds: str):
    def p(name):
        return osp.join(data_root, name)

    if stage == "chairs":
        aug = {"crop_size": image_size, "min_scale": -0.1, "max_scale": 1.0,
               "do_flip": True}
        return FlyingChairs(aug, split="training",
                            root=p("FlyingChairs_release/data"))

    if stage == "things":
        aug = {"crop_size": image_size, "min_scale": -0.4, "max_scale": 0.8,
               "do_flip": True}
        clean = FlyingThings3D(aug, root=p("FlyingThings3D"),
                               dstype="frames_cleanpass")
        final = FlyingThings3D(aug, root=p("FlyingThings3D"),
                               dstype="frames_finalpass")
        return ConcatDataset([clean, final])

    if stage == "sintel":
        aug = {"crop_size": image_size, "min_scale": -0.2, "max_scale": 0.6,
               "do_flip": True}
        things = FlyingThings3D(aug, root=p("FlyingThings3D"),
                                dstype="frames_cleanpass")
        sintel_clean = MpiSintel(aug, split="training", root=p("Sintel"),
                                 dstype="clean")
        sintel_final = MpiSintel(aug, split="training", root=p("Sintel"),
                                 dstype="final")
        if train_ds == "C+T+K+S+H":
            kitti = KITTI({"crop_size": image_size, "min_scale": -0.3,
                           "max_scale": 0.5, "do_flip": True},
                          root=p("KITTI"))
            hd1k = HD1K({"crop_size": image_size, "min_scale": -0.5,
                         "max_scale": 0.2, "do_flip": True}, root=p("HD1k"))
            return ConcatDataset([100 * sintel_clean, 100 * sintel_final,
                                  200 * kitti, 5 * hd1k, things])
        return ConcatDataset([100 * sintel_clean, 100 * sintel_final, things])

    if stage == "kitti":
        aug = {"crop_size": image_size, "min_scale": -0.2, "max_scale": 0.4,
               "do_flip": False}
        return KITTI(aug, split="training", root=p("KITTI"))

    raise ValueError(f"unknown stage {stage!r}")
