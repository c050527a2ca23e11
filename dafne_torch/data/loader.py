"""Train samplers and the batch loader.

Counterpart of ``dafne_tpu/data/loader.py``: ``training_sampler``,
``repeat_factors``, ``repeat_factor_sampler`` and ``build_sampler``
(:28-74) give the same index streams for the same seed.  ``DataLoader``
yields torch tensors: the uint8 canvases and the mapper's arrays stacked
into one batch, in pinned memory when asked, ready for a non-blocking copy
to the card.  Training batches are infinite, drawn with the JAX loader's
per-example seeds and prefetched by a producer thread; eval batches (:232)
walk the records in order, the last batch padded with repeats of its last
record, with each slot's ``image_id`` and ``batch_valid``.  With
``device_aug`` (:90-160) a train batch holds the base images
("image_base", on the ``device_aug_base_hw`` canvas) and the mapper's warp
and color vectors instead of rendered canvases; records without a size
fall back to the host path.  With ``buckets`` (a ``TrainScaleBuckets``,
TPU.BUCKETED_TRAIN, :193-210) one shortest-edge scale is drawn per batch
from its own stream, ``RandomState(seed * 7919 + 13)``, after the batch's
indices and seeds, and the batch renders onto that scale's canvas.

With several processes (``process_index`` of ``process_count``, :87-108,
212-247) ``batch_size`` is the global batch: every process draws the same
sampler stream, per-example seeds and bucket scales, and maps only its rows
``proc_lo:proc_hi``, so the processes' rows together are the one-process
batch.  An eval batch's ``image_id`` and ``batch_valid`` stay global, for
the evaluator of process 0.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from dafne_torch.data.mapper import DatasetMapper, device_aug_base_hw, pad_target_hw

GT_KEYS = ("gt_corners", "gt_hbox", "gt_classes", "gt_area", "gt_valid")


def training_sampler(n: int, seed: int = 0) -> Iterator[int]:
    """Infinite stream of shuffled epoch permutations."""
    rng = np.random.RandomState(seed)
    while True:
        for i in rng.permutation(n):
            yield int(i)


def repeat_factors(records: List[dict], threshold: float) -> np.ndarray:
    """Per-image repeat factor: max over its categories of sqrt(t / freq)."""
    n = len(records)
    freq: Dict[int, float] = {}
    for r in records:
        for cat in {a["category_id"] for a in r.get("annotations", [])}:
            freq[cat] = freq.get(cat, 0) + 1
    for k in freq:
        freq[k] /= n
    factors = np.ones(n)
    for i, r in enumerate(records):
        cats = {a["category_id"] for a in r.get("annotations", [])}
        if cats:
            factors[i] = max(max(1.0, np.sqrt(threshold / freq[c])) for c in cats)
    return factors


def repeat_factor_sampler(records: List[dict], threshold: float, seed: int = 0) -> Iterator[int]:
    """RepeatFactorTrainingSampler: each epoch repeats image i floor(f_i)
    times plus once more with probability frac(f_i), shuffled."""
    factors = repeat_factors(records, threshold)
    floors = np.floor(factors).astype(np.int64)
    frac = factors - floors
    rng = np.random.RandomState(seed)
    while True:
        counts = floors + (rng.rand(len(records)) < frac)
        epoch = np.repeat(np.arange(len(records)), counts)
        rng.shuffle(epoch)
        for i in epoch:
            yield int(i)


def build_sampler(cfg, records: List[dict], seed: int = 0) -> Iterator[int]:
    if cfg.DATALOADER.SAMPLER_TRAIN == "RepeatFactorTrainingSampler":
        return repeat_factor_sampler(records, cfg.DATALOADER.REPEAT_THRESHOLD, seed)
    return training_sampler(len(records), seed)


class DataLoader:
    """Batches of `batch_size` over `records`, mapped by
    DATALOADER.NUM_WORKERS threads.  `train`: infinite, kept
    TPU.PREFETCH_DEPTH batches ahead by a producer thread; else one pass in
    record order (``len`` batches).  `device_aug` (train only): device-aug
    batches; ``self.device_aug`` says whether the loader makes them.
    `buckets` (train only): a ``TrainScaleBuckets``, whose per-batch draw
    sets each batch's scale and canvas.  `process_index` of
    `process_count`: the rows of the global `batch_size` this process maps."""

    def __init__(self, cfg, records: List[dict], batch_size: int, seed: int = 0,
                 pad_hw: Optional[Tuple[int, int]] = None, pin_memory: bool = False,
                 train: bool = True, device_aug: bool = False, buckets=None,
                 process_index: int = 0, process_count: int = 1):
        if batch_size % process_count:
            raise ValueError(f"batch {batch_size} does not split over {process_count} processes")
        self.proc_lo = batch_size // process_count * process_index
        self.proc_hi = self.proc_lo + batch_size // process_count
        if train and cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS:
            records = [r for r in records if r.get("annotations")] or records
        self.records = records
        self.batch_size = batch_size
        self.train = train
        self.base_hw = device_aug_base_hw(records) if device_aug and train else None
        self.device_aug = self.base_hw is not None
        if device_aug and train and not self.device_aug:
            logging.getLogger("dafne_torch").warning(
                "TPU.TRAIN_DEVICE_AUG: records lack width/height; falling back to host-side "
                "augmentation")
        self.mapper = DatasetMapper(cfg, pad_hw or pad_target_hw(cfg, train=train), train=train,
                                    device_aug=self.device_aug)
        self.num_workers = cfg.DATALOADER.NUM_WORKERS
        self.prefetch = max(1, cfg.TPU.PREFETCH_DEPTH)
        self.seed = seed
        self.pin_memory = pin_memory
        self.sampler = build_sampler(cfg, self.records, seed) if train else None
        self.buckets = buckets if train else None

    def make_batch(self, indices: List[int], seeds: List[int],
                   pool: Optional[ThreadPoolExecutor] = None, min_size: Optional[int] = None,
                   pad_hw: Optional[Tuple[int, int]] = None) -> Dict:
        """Map records `indices` with RandomState(seeds[i]) each, rendering
        straight into one [B, pad_h, pad_w, 3] uint8 tensor ("image"), or
        with device aug placing the base images in one [B, *base_hw, 3]
        ("image_base").  `min_size` and `pad_hw` override the scale draw
        and the canvas (a bucket's)."""
        pad_hw = tuple(pad_hw) if pad_hw is not None else (self.mapper.pad_h, self.mapper.pad_w)
        hw = self.base_hw if self.device_aug else pad_hw
        images = torch.zeros((len(indices), *hw, 3), dtype=torch.uint8,
                             pin_memory=self.pin_memory)
        view = images.numpy()

        def one(args):
            slot, i, s = args
            return self.mapper(self.records[i], np.random.RandomState(s), image_out=view[slot],
                               min_size=min_size, pad_hw=pad_hw)

        work = list(zip(range(len(indices)), indices, seeds))
        examples = list(pool.map(one, work)) if pool is not None else [one(a) for a in work]
        img_key = "image_base" if self.device_aug else "image"
        batch = {img_key: images, "image_id": [e["image_id"] for e in examples]}
        for k in examples[0]:
            if k not in batch:
                t = torch.from_numpy(np.stack([e[k] for e in examples]))
                batch[k] = t.pin_memory() if self.pin_memory else t
        return batch

    def __len__(self):
        if self.train:
            raise TypeError("the train loader is infinite")
        return -(-len(self.records) // self.batch_size)

    def __iter__(self):
        return self._train_iter() if self.train else self._eval_iter()

    def _eval_iter(self):
        n = len(self.records)
        with ThreadPoolExecutor(max(self.num_workers, 1)) as pool:
            for start in range(0, n, self.batch_size):
                idx = list(range(start, min(start + self.batch_size, n)))
                real = len(idx)
                idx += [idx[-1]] * (self.batch_size - real)  # pad the last batch
                local = idx[self.proc_lo:self.proc_hi]
                batch = self.make_batch(local, [0] * len(local),
                                        pool if self.num_workers > 0 else None)
                batch["image_id"] = [self.records[i].get("image_id", str(i)) for i in idx]
                batch["batch_valid"] = np.arange(self.batch_size) < real
                yield batch

    def _train_iter(self):
        seed_counter = itertools.count(self.seed * 1_000_003 + 1)
        scale_rng = np.random.RandomState(self.seed * 7919 + 13)  # per-batch scale draws
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(max(self.num_workers, 1)) as pool:
                    while not stop.is_set():
                        idx = [next(self.sampler) for _ in range(self.batch_size)]
                        seeds = [next(seed_counter) % (2**31) for _ in idx]
                        min_size = pad_hw = None
                        if self.buckets is not None:
                            min_size, pad_hw = self.buckets.draw(scale_rng)
                        lo, hi = self.proc_lo, self.proc_hi  # this process's rows
                        q.put(self.make_batch(idx[lo:hi], seeds[lo:hi],
                                              pool if self.num_workers > 0 else None,
                                              min_size, pad_hw))
            except Exception as e:  # surface it in the consumer instead of hanging
                q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            try:  # unblock a producer waiting on a full queue
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            # the producer finishes the batch it is mapping, puts it in the
            # emptied queue and stops: wait for it, so that no warp runs on
            # a worker thread while the interpreter exits
            thread.join()
