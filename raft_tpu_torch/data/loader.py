"""Threaded prefetching batch loader, port of ``raft_tpu/data/loader.py``.

The reference uses ``torch.utils.data.DataLoader(num_workers=4, shuffle=True,
drop_last=True)`` (datasets.py:230-231). Here, as in the JAX package, a pool
of threads decodes and augments samples while the card steps (numpy and
zlib release the GIL for the heavy parts), each worker reseeding the
dataset's augmentor as the reference reseeds per worker (datasets.py:45-51).
Batch ``k`` of an epoch is always the shuffled indices ``k·B .. k·B+B-1``,
whichever worker made it.

Batches are dicts of stacked numpy arrays; the trainer moves them to the
card (pinned memory, ``non_blocking`` copies, two batches ahead).

In a data-parallel run each rank builds its loader with ``rows=`` (its
``process_batch_slice``): every rank walks the same seeded global order
and decodes only its rows of each global batch. The augmentation draws
stay per worker, each worker reseeded with the rank too, so an N-rank
run's augmented batch is not bitwise a one-rank run's (the reference's
per-worker reseed is not either); a run that must match one rank passes
the trainer whole batches through ``loader=``.
"""

from __future__ import annotations

import os
import queue
import threading
import warnings
from typing import Dict, Iterator, Optional

import numpy as np

from raft_tpu_torch.data.datasets import fetch_dataset
from raft_tpu_torch.testing import faults

#: on_bad_sample="skip" gives up after this many consecutive failures
#: for ONE slot — a dataset where every draw fails is systematically
#: broken, and resampling forever would spin a worker thread
_MAX_RESAMPLES = 8


class LoaderStallError(RuntimeError):
    """The consumer's stall deadline (``stall_s``) expired waiting for a
    batch: a worker is stuck inside decode/augment (hung codec, dead NFS
    mount). Named so callers can tell a hung data pipeline from a wedged
    card."""


def _collate(samples, wire_dtype: str = "float32",
             check: bool = False) -> Dict[str, np.ndarray]:
    img1, img2, flow, valid = zip(*samples)
    if wire_dtype == "uint8":
        # The uint8 wire: images and valid travel as uint8 and the train
        # step casts them back on the device. Lossless: every augmentation
        # runs on uint8 images and the final float32 cast only widens, and
        # valid is a 0/1 mask; flow stays float32. Cast per sample before
        # the stack, so the float32 batch never materializes here.
        if check:
            for name, s in (("image1", img1[0]), ("image2", img2[0])):
                s = np.asarray(s)
                if not (s.min() >= 0 and s.max() <= 255
                        and np.array_equal(s, np.floor(s))):
                    raise ValueError(
                        "wire_dtype='uint8' requires integral [0,255] "
                        f"images (the augmentor contract) — {name} has "
                        f"values in [{s.min():.3g}, {s.max():.3g}]; use "
                        "wire_dtype='float32' for this dataset")
            v = np.asarray(valid[0])
            if not np.isin(v, (0.0, 1.0)).all():
                raise ValueError(
                    "wire_dtype='uint8' requires a 0/1 valid mask — got "
                    f"values in [{v.min():.3g}, {v.max():.3g}] (fractional "
                    "weights would be truncated); use wire_dtype='float32'")
        img1 = [np.asarray(x, np.uint8) for x in img1]
        img2 = [np.asarray(x, np.uint8) for x in img2]
        valid = [np.asarray(v, np.uint8) for v in valid]
    return {
        "image1": np.stack(img1),
        "image2": np.stack(img2),
        "flow": np.stack(flow),
        "valid": np.stack(valid),
    }


class PrefetchLoader:
    """Shuffled, batched, prefetching iterator over a FlowDataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, drop_last: bool = True,
                 seed: int = 1234, prefetch: int = 4, clamp: bool = True,
                 wire_dtype: str = "float32",
                 on_bad_sample: str = "raise", stall_s: float = 0.0,
                 rows: Optional[slice] = None):
        """``rows``: the rows of each global batch of ``batch_size`` this
        loader yields (a data-parallel rank's share); None yields
        whole batches."""
        if wire_dtype not in ("float32", "uint8"):
            raise ValueError(f"wire_dtype={wire_dtype!r}: choose float32 "
                             "or uint8 (see _collate)")
        if on_bad_sample not in ("raise", "skip"):
            raise ValueError(f"on_bad_sample={on_bad_sample!r}: choose "
                             "'raise' (surface decode errors) or 'skip' "
                             "(resample with a counted warning)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.wire_dtype = wire_dtype
        self.on_bad_sample = on_bad_sample
        # consumer-side deadline per batch; 0 keeps the legacy wait-
        # forever behavior (the stable contract for callers that own
        # their own watchdog)
        self.stall_s = float(stall_s)
        self.bad_samples = 0  # running skip count across epochs
        self._bad_lock = threading.Lock()
        # clamp to the host: more worker threads than spare cores only buy
        # GIL and queue contention. sched_getaffinity sees cgroup/taskset
        # pinning that cpu_count misses.
        try:
            cores = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):
            cores = os.cpu_count() or 1
        spare = max(1, cores - 1)
        self.num_workers = (max(1, min(num_workers, spare)) if clamp
                            else max(1, num_workers))
        if self.num_workers != num_workers:
            warnings.warn(
                f"PrefetchLoader: clamped num_workers {num_workers} -> "
                f"{self.num_workers} ({cores} usable cores; extra "
                "threads only add GIL contention)", stacklevel=2)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0
        self._skip = 0  # batches the next epoch leaves out (start_at)
        self.rows = rows
        #: added to the workers' augmentation seeds: 0 for a whole-batch
        #: loader and rank 0, another stream for every other rank's rows
        self._rank_salt = 0 if rows is None else 7907 * int(rows.start or 0)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _sample(self, index: int, resample: np.random.RandomState):
        """One dataset fetch under the ``on_bad_sample`` policy:
        'raise' surfaces decode errors to the consumer verbatim; 'skip'
        draws a replacement index (counted, warned) so one rotten file
        doesn't kill a multi-day run."""
        tries = 0
        while True:
            try:
                faults.fault_point("loader.sample")
                return self.dataset[index]
            except Exception as exc:
                if self.on_bad_sample != "skip":
                    raise
                tries += 1
                if tries >= _MAX_RESAMPLES:
                    raise RuntimeError(
                        f"on_bad_sample='skip' gave up after "
                        f"{_MAX_RESAMPLES} consecutive bad samples "
                        f"(last: {type(exc).__name__}: {exc}) — the "
                        "dataset looks systematically broken, not "
                        "spotty") from exc
                with self._bad_lock:
                    self.bad_samples += 1
                    n = self.bad_samples
                warnings.warn(
                    f"PrefetchLoader: skipped bad sample {index} "
                    f"({type(exc).__name__}: {exc}); resampling "
                    f"({n} skipped so far)", stacklevel=2)
                index = int(resample.randint(len(self.dataset)))

    def start_at(self, step: int) -> None:
        """Continue the batch sequence at global batch ``step``, as a run
        resumed at that step needs: epoch ``step // len(self)``, whose first
        ``step % len(self)`` batches are left out undrawn. The samples come
        in the uninterrupted run's order. Their augmentation draws match it
        at an epoch boundary with one worker: a worker reseeds the shared
        augmentor once per epoch and then draws sample after sample (with
        more workers the draws follow thread timing in any run)."""
        self.epoch, self._skip = divmod(int(step), len(self))

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        if self.drop_last:
            idx = idx[:len(self) * self.batch_size]
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._epoch_indices()
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.rows is not None:
            batches = [b[self.rows] for b in batches]
        batches, self._skip = batches[self._skip:], 0
        self.epoch += 1

        task_q: "queue.Queue" = queue.Queue()
        results: Dict[int, object] = {}
        cond = threading.Condition()
        stop = threading.Event()
        # bound how far workers run ahead of consumption
        ahead = threading.Semaphore(self.prefetch + self.num_workers)

        for bi, batch_idx in enumerate(batches):
            task_q.put((bi, batch_idx))

        def worker(worker_id: int):
            # per-worker reseed (datasets.py:45-51 analog)
            if hasattr(self.dataset, "reseed"):
                self.dataset.reseed(self.seed + worker_id * 7919 + self.epoch
                                    + self._rank_salt)
            resample = np.random.RandomState(
                self.seed + worker_id * 104729 + self.epoch
                + self._rank_salt)
            while not stop.is_set():
                ahead.acquire()
                if stop.is_set():
                    return  # woken by the consumer's shutdown release
                try:
                    bi, batch_idx = task_q.get_nowait()
                except queue.Empty:
                    ahead.release()
                    return
                try:
                    batch = _collate([self._sample(int(i), resample)
                                      for i in batch_idx],
                                     self.wire_dtype,
                                     check=(bi == 0))
                except Exception as e:  # surface decode errors to consumer
                    batch = e
                with cond:
                    results[bi] = batch
                    cond.notify_all()

        threads = [threading.Thread(target=worker, args=(w,), daemon=True,
                                    name=f"PrefetchLoader-w{w}")
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()

        try:
            for next_bi in range(len(batches)):
                with cond:
                    if not cond.wait_for(lambda: next_bi in results,
                                         timeout=self.stall_s or None):
                        raise LoaderStallError(
                            f"batch {next_bi} not produced within "
                            f"stall_s={self.stall_s:.0f}s — a worker is "
                            "stuck in decode/augment; see "
                            "PrefetchLoader(stall_s=, on_bad_sample=)")
                    batch = results.pop(next_bi)
                ahead.release()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            # wake every worker parked in ahead.acquire(): on an early
            # consumer exit (break, exception, stall) nobody would ever
            # release again, stranding them there past `stop` forever —
            # one leaked thread set per partial epoch in a long-lived
            # process. Workers re-check `stop` right after acquiring.
            for _ in threads:
                ahead.release()
            with cond:
                results.clear()


def fetch_dataloader(stage: str, image_size, batch_size: int,
                     data_root: str = "datasets", num_workers: int = 4,
                     seed: int = 1234, wire_dtype: str = "float32",
                     on_bad_sample: str = "raise",
                     stall_s: float = 0.0,
                     rows: Optional[slice] = None) -> PrefetchLoader:
    """Stage-preset loader, the fetch_dataloader analog (datasets.py:199).

    The default wire is float32 (batches safe for host arithmetic); the
    trainer passes ``wire_dtype="uint8"`` (see :func:`_collate`), and a
    data-parallel rank its ``rows``.
    """

    dataset = fetch_dataset(stage, image_size, data_root)
    print(f"Training with {len(dataset)} image pairs")
    return PrefetchLoader(dataset, batch_size, shuffle=True,
                          num_workers=num_workers, drop_last=True, seed=seed,
                          wire_dtype=wire_dtype,
                          on_bad_sample=on_bad_sample, stall_s=stall_s,
                          rows=rows)
