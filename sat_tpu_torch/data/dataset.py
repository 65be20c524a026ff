"""Streaming caption dataset and batch loader.

Port of sat_tpu/data/dataset.py. Batches are numpy arrays ready for the
device:

  imgs         (B, S, S, 3) float32, NHWC, ImageNet-normalized (or None)
  captions     (B, T) int32
  all_captions (B, n_caps, T) int32  — every caption of each row's image
  indices      (B,) dataset rows, when `with_indices`

As in sat_tpu: items are caption rows, so an image with 5 captions comes 5
times an epoch; `fraction` truncates the front of the split; the groups of
all captions are padded to one width with each group's first caption. An
epoch's order is a permutation seeded by (seed, epoch) with numpy, the
same as sat_tpu's, and a producer thread prefetches batches. With
`bert` the captions are the BERT ids of `{split}_captions_bert.json`
(data/bert_prep.py's layout). Under SAT_NATIVE_PREPROC=1 a batch's cache
misses are decoded by one call of the native loader's thread pool
(data/native.py), and only the files its codecs reject go through the
per-image path; `native_rows` counts the rows the native tier decoded.

Data parallel (parallel/distributed.py): node h of H takes the stripe
`order[h::H]` of each epoch's permutation, as sat_tpu's host h does, so
the union of the nodes' batch b is the global batch b. Within a node,
each batch is padded to a multiple of the node's data ranks by repeating
its last row, and the node's data rank r takes the r-th contiguous slice
of the padded batch, as row r of sat_tpu's mesh does (`local_index`,
`local_count`; the trainer passes the data index within the node, so the
M ranks of a model group read the same rows). `row_mask(b)` marks a slice's real rows and
`global_rows(b)` counts the global batch's: both follow from the schedule
alone.
"""

from __future__ import annotations

import json
import queue
import threading
from collections import defaultdict
from typing import Iterator, Optional

import numpy as np

from sat_tpu_torch.data.transforms import (load_and_preprocess_image,
                                           native_enabled)
from sat_tpu_torch.parallel.mesh import pad_batch, slice_bounds


class CacheBudget:
    """Thread-safe byte budget shared by the splits' image caches."""

    def __init__(self, total_bytes: int):
        self.remaining = int(total_bytes)
        self._lock = threading.Lock()

    def take(self, n: int) -> bool:
        with self._lock:
            if self.remaining >= n:
                self.remaining -= n
                return True
            return False


class CaptionDataset:
    def __init__(self, data_path: str, split_type: str = "train",
                 fraction: float = 1.0, bert: bool = False,
                 cache_images: bool = True, image_size: int = 224,
                 cache_budget: Optional[CacheBudget] = None):
        self.data_path = data_path
        self.split_type = split_type
        self.image_size = image_size

        with open(f"{data_path}/{split_type}_img_paths.json") as f:
            img_paths = json.load(f)
        suffix = "_captions_bert.json" if bert else "_captions.json"
        with open(f"{data_path}/{split_type}{suffix}") as f:
            captions = json.load(f)
        if fraction != 1.0:
            img_paths = img_paths[:int(len(img_paths) * fraction)]
            captions = captions[:int(len(captions) * fraction)]

        self.img_paths = img_paths
        self.captions = np.asarray(captions, dtype=np.int32)

        groups = defaultdict(list)
        for path, caption in zip(img_paths, captions):
            groups[path].append(caption)
        n_caps = max((len(g) for g in groups.values()), default=1)
        self.all_captions = np.asarray(
            [groups[p] + [groups[p][0]] * (n_caps - len(groups[p]))
             for p in img_paths], dtype=np.int32)

        # Decoded images, cap-and-stop under the shared byte budget: an
        # epoch's order is a fresh permutation, so recency says nothing.
        self._cache: Optional[dict] = {} if cache_images else None
        self._cache_budget = cache_budget
        self._cache_lock = threading.Lock()
        self.native_rows = 0     # rows decoded by the native batch loader

    def _cache_put(self, path: str, img: np.ndarray) -> None:
        with self._cache_lock:
            if path in self._cache:
                return
            if (self._cache_budget is not None
                    and not self._cache_budget.take(img.nbytes)):
                return
            # a row of a batch buffer would pin the whole buffer
            self._cache[path] = img if img.base is None else img.copy()

    def __len__(self) -> int:
        return len(self.img_paths)

    @property
    def caption_length(self) -> int:
        return self.captions.shape[1]

    def load_image(self, index: int) -> np.ndarray:
        path = self.img_paths[index]
        if self._cache is not None:
            with self._cache_lock:
                hit = self._cache.get(path)
            if hit is not None:
                return hit
        img = load_and_preprocess_image(path, self.image_size)
        if self._cache is not None:
            self._cache_put(path, img)
        return img

    def load_image_batch(self, idxs) -> np.ndarray:
        """The images of rows `idxs`, (B, S, S, 3). Cache hits first; under
        SAT_NATIVE_PREPROC=1 with the native codecs built, the misses in
        one thread-pool call, whose rows fill the cache; every other miss,
        and a file the codecs reject, through `load_image`."""
        out = [None] * len(idxs)
        if self._cache is not None:
            with self._cache_lock:
                for pos, i in enumerate(idxs):
                    out[pos] = self._cache.get(self.img_paths[i])
        miss = [pos for pos, img in enumerate(out) if img is None]

        if miss and native_enabled():
            from sat_tpu_torch.data import native
            if native.decode_support():
                imgs, status = native.load_images(
                    [self.img_paths[idxs[pos]] for pos in miss],
                    self.image_size)
                done = [(pos, imgs[k]) for k, pos in enumerate(miss)
                        if status[k] == native.OK]
                for pos, img in done:
                    out[pos] = img
                    if self._cache is not None:
                        self._cache_put(self.img_paths[idxs[pos]], img)
                with self._cache_lock:
                    self.native_rows += len(done)
                miss = [pos for pos in miss if out[pos] is None]

        for pos in miss:
            out[pos] = self.load_image(idxs[pos])
        return np.stack(out)

    def __getitem__(self, index: int):
        return (self.load_image(index), self.captions[index],
                self.all_captions[index])


class BatchLoader:
    """Shuffling, sharding, prefetching batch iterator: one epoch is
    `for batch in loader.epoch(epoch_num)`. The final partial batch is kept
    unless `drop_last`, as in the reference's DataLoader. `shard_index` and
    `shard_count` pick the node's stripe, `local_index` and `local_count`
    the rank's slice of each of its batches (module note)."""

    def __init__(self, dataset: CaptionDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 42,
                 shard_index: int = 0, shard_count: int = 1,
                 local_index: int = 0, local_count: int = 1,
                 prefetch: int = 2, drop_last: bool = False,
                 with_indices: bool = False, load_images: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.local_index = local_index
        self.local_count = local_count
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.with_indices = with_indices
        self.load_images = load_images

    def _stripe_rows(self) -> int:
        return len(self.dataset) // self.shard_count

    def batches_per_epoch(self) -> int:
        n = self._stripe_rows()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def batch_rows(self, b: int) -> int:
        """Real rows of the node's batch b."""
        return min(self.batch_size, self._stripe_rows() - b * self.batch_size)

    def global_rows(self, b: int) -> int:
        """Real rows of the global batch b: every node's batch b has as
        many."""
        return self.batch_rows(b) * self.shard_count

    def row_mask(self, b: int) -> Optional[np.ndarray]:
        """The real rows of this rank's slice of batch b, or None when the
        node's batch needed no padding."""
        n, parts = self.batch_rows(b), self.local_count
        if n % parts == 0:
            return None
        lo, hi = slice_bounds(-(-n // parts) * parts, parts, self.local_index)
        return np.arange(lo, hi) < n

    def _local_slice(self, idxs: np.ndarray) -> np.ndarray:
        if self.local_count <= 1:
            return idxs
        (padded,), _ = pad_batch([idxs], self.local_count)
        return padded[slice(*slice_bounds(len(padded), self.local_count,
                                          self.local_index))]

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(n)
        else:
            order = np.arange(n)
        if self.shard_count == 1:
            return order
        # host h's stripe: the union of the stripes' batch b is
        # order[b*bs*H : (b+1)*bs*H], the global batch b
        per_shard = n // self.shard_count
        return order[:per_shard * self.shard_count][
            self.shard_index::self.shard_count]

    def _make_batch(self, idxs: np.ndarray):
        imgs = (self.dataset.load_image_batch(idxs)
                if self.load_images else None)
        batch = (imgs, self.dataset.captions[idxs],
                 self.dataset.all_captions[idxs])
        if self.with_indices:
            return batch + (np.asarray(idxs),)
        return batch

    def epoch(self, epoch: int = 0, skip: int = 0) -> Iterator[tuple]:
        """Yield the epoch's batches after the first `skip`, which are
        never materialized."""
        order = self._epoch_indices(epoch)
        bs = self.batch_size
        splits = [order[i:i + bs] for i in range(0, len(order), bs)]
        if self.drop_last and splits and len(splits[-1]) < bs:
            splits.pop()
        splits = [self._local_slice(s) for s in splits[skip:]]
        if self.prefetch <= 0:
            for idxs in splits:
                yield self._make_batch(idxs)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        cancelled = threading.Event()

        def put(item) -> None:
            # Bounded put with a cancellation check: an abandoned iterator
            # must not leave this thread blocked on a full queue.
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def producer():
            try:
                for idxs in splits:
                    if cancelled.is_set():
                        return
                    put(self._make_batch(idxs))
            except Exception as exc:   # re-raised in the consumer
                put(exc)
            finally:
                put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            cancelled.set()
            t.join(timeout=5)

    def __iter__(self):
        return self.epoch(0)
