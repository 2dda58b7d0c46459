"""Batch loader: sharded shuffling sampler + background prefetch.

The port's own copy of `ddgan_tpu/data/loader.py`, which replaces torch
DataLoader + DistributedSampler (ddgan.py:242-269). Each shard sees a
deterministic per-epoch slice of the global index permutation, seeded by
(seed, epoch) (`set_epoch`); batches are stacked float32 NHWC numpy arrays,
the JAX loader's batches exactly; the train loop makes them NCHW on the
device. Prefetching runs on worker threads (the dataset __getitem__ is
IO-bound: gzip and numpy release the GIL).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from .transforms import Compose, Normalize, ToTensor


class SyntheticDataset:
    """Deterministic random images for tests/benchmarks (no files needed)."""

    def __init__(self, n: int = 256, image_size: int = 32, num_channels: int = 3, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.data = rng.uniform(-1, 1, (n, image_size, image_size, num_channels)).astype(
            np.float32
        )

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i], 1


def _to_array(x) -> np.ndarray:
    arr = np.asarray(x, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


class DataLoader:
    """Iterate (images, labels) batches: images float32 (B, H, W, C).

    Args:
      dataset: __len__/__getitem__ -> (image, label).
      batch_size: per-host batch (global batch = batch_size * num_hosts
        when sharding; on a single host it is the global batch).
      shuffle: new permutation per epoch, seeded by (seed, epoch).
      drop_last: drop trailing partial batch (reference always does,
        ddgan.py:252,:261).
      num_shards/shard_id: host-level sharding (process_count/index).
      num_workers: prefetch threads; 0 = synchronous.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_shards: int = 1,
        shard_id: int = 0,
        num_workers: int = 0,
        seed: int = 0,
        prefetch: int = 4,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.num_workers = num_workers
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """DistributedSampler.set_epoch analog (ddgan.py:430-431)."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        # pad so every shard sees the same count (DistributedSampler semantics)
        per_shard = -(-n // self.num_shards)
        if self.num_shards > 1:
            padded = np.concatenate([order, order[: per_shard * self.num_shards - n]])
            order = padded[self.shard_id :: self.num_shards]
        return order

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _vectorized_transform(self):
        """(scale, mean, std) when the dataset's transform pipeline is
        expressible as one vectorized batch op (ToTensor → Normalize, the
        CIFAR recipe's exact pipeline), else None. Lets uint8 array-backed
        datasets skip the per-image transform entirely: one gather and
        one batch normalize per batch."""
        tf = getattr(self.dataset, "transform", None)
        if tf is None:
            return (1.0, None, None)
        if not isinstance(tf, Compose):
            return None
        scale, mean, std = 1.0, None, None
        for t in tf.transforms:
            if isinstance(t, ToTensor):
                scale = 1.0 / 255.0
            elif isinstance(t, Normalize) and mean is None:
                mean, std = t.mean, t.std
            else:
                return None
        return (scale, mean, std)

    def _make_batch(self, idx_chunk) -> tuple[np.ndarray, np.ndarray]:
        # vectorized fast path: array-backed datasets (SyntheticDataset,
        # CIFAR-10 pickles) gather the whole batch in one
        # numpy indexing op; ToTensor/Normalize apply batch-wise
        data = getattr(self.dataset, "data", None)
        if isinstance(data, np.ndarray) and data.ndim == 4 and data.dtype in (
            np.float32,
            np.uint8,
        ):
            vt = self._vectorized_transform()
            # uint8 data is only eligible when ToTensor is present (its /255
            # is what the per-image path would apply; without it the slow
            # path's float32 cast semantics differ)
            if vt is not None and (data.dtype == np.float32 or vt[0] != 1.0):
                scale, mean, std = vt
                if data.dtype != np.uint8:
                    scale = 1.0  # ToTensor does NOT rescale non-uint8 input
                idx = np.asarray(idx_chunk, dtype=np.int64)
                batch = data[idx].astype(np.float32)
                if scale != 1.0:
                    batch *= np.float32(scale)
                if mean is not None:
                    batch -= mean.reshape(1, 1, 1, -1)
                    batch /= std.reshape(1, 1, 1, -1)
                targets = getattr(self.dataset, "targets", None)
                if targets is not None:
                    labels = np.asarray(targets, dtype=np.int64)[idx]
                else:
                    labels = np.ones(len(idx), dtype=np.int64)
                return batch, labels
        imgs, labels = [], []
        for i in idx_chunk:
            item = self.dataset[int(i)]
            if isinstance(item, tuple):
                img, label = item[0], item[1]
            else:
                img, label = item, 0
            imgs.append(_to_array(img))
            if isinstance(label, (int, float, np.integer, np.floating)):
                labels.append(label)
            else:
                labels.append(0)
        return np.stack(imgs), np.asarray(labels)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        order = self._indices()
        nb = len(self)
        chunks = [
            order[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)
        ]

        if self.num_workers <= 0:
            for ch in chunks:
                yield self._make_batch(ch)
            return

        # N worker threads pull batch indices from a task queue and deposit
        # (index, batch) results; the consumer re-sequences them so output
        # order is deterministic regardless of worker scheduling. All puts
        # poll the stop event so an early consumer exit (limited_iter smoke
        # runs) never leaves a worker blocked on a full queue.
        tasks: queue.Queue = queue.Queue()
        for i, ch in enumerate(chunks):
            tasks.put((i, ch))
        results: queue.Queue = queue.Queue(maxsize=max(self.prefetch, self.num_workers))
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    i, ch = tasks.get_nowait()
                except queue.Empty:
                    return
                try:
                    item = (i, self._make_batch(ch))
                except BaseException as e:  # noqa: BLE001 — re-raised in consumer
                    # torch DataLoader re-raises worker errors in the main
                    # process; swallowing one here would leave the consumer
                    # blocked forever on this batch index
                    item = (i, e)
                while not stop.is_set():
                    try:
                        results.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(max(1, self.num_workers))
        ]
        for t in threads:
            t.start()
        pending: dict[int, tuple] = {}
        try:
            for want in range(nb):
                while want not in pending:
                    i, batch = results.get()
                    if isinstance(batch, BaseException):
                        raise batch
                    pending[i] = batch
                yield pending.pop(want)
        finally:
            stop.set()
