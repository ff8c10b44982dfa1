"""Asynchronous host loader: thread-pool sample decode + batch prefetch.

Replacement for the reference's DataLoader(num_workers=16, pin_memory,
prefetch_factor=2, persistent_workers) (modules/trainer.py:432-433): a thread
pool decodes DICOM + generates masks (NumPy releases the GIL for the heavy
scipy/numpy work), batches are assembled as stacked NHWC arrays, and a
bounded queue keeps `prefetch` batches ready so host I/O overlaps device
steps. Batches are padded to a fixed batch size by wrapping (static shapes,
as in the JAX package; the reference instead emits a ragged final batch) — a padded batch
carries a per-sample "weight" vector (1 real / 0 padded) so the loss suite
can reproduce the ragged batch's gradients exactly (losses/basic.wmean).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np


class HostLoader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 8, prefetch: int = 2,
                 drop_last: bool = False, pad_final: bool = True,
                 shard: tuple[int, int] | None = None):
        """`batch_size` is the GLOBAL batch. With `shard=(i, n)` (multi-host
        data parallelism) this loader decodes only rows [i*b/n, (i+1)*b/n)
        of every global batch — each host feeds its own devices and
        `parallel.global_shard_batch` assembles the global array. The epoch
        order, padding, and weights are derived from the same seed on every
        host, so shards are consistent by construction."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.pad_final = pad_final
        if shard is not None:
            idx, count = shard
            if batch_size % count != 0:
                raise ValueError(f"global batch {batch_size} not divisible "
                                 f"by {count} processes")
            if not 0 <= idx < count:
                raise ValueError(f"shard index {idx} out of range({count})")
        self.shard = shard
        self._epoch = 0

    @property
    def final_n_real(self) -> int | None:
        """GLOBAL number of real samples in the wrap-padded final batch, or
        None when every batch is full (the static n_real for the weighted
        train step — identical on all hosts)."""
        if self.drop_last or not self.pad_final:
            return None
        rem = len(self.dataset) % self.batch_size
        return rem if rem else None

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _local_rows(self) -> slice:
        if self.shard is None:
            return slice(None)
        idx, count = self.shard
        local = self.batch_size // count
        return slice(idx * local, (idx + 1) * local)

    def _index_order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._index_order()
        self._epoch += 1
        n = len(order)
        batches = []  # (indices, n_real) pairs
        for start in range(0, n, self.batch_size):
            chunk = order[start:start + self.batch_size]
            n_real = len(chunk)
            if n_real < self.batch_size:
                if self.drop_last:
                    continue
                if self.pad_final:
                    # wrap-around padding; cycles when the dataset itself is
                    # smaller than one batch (static shapes). The
                    # duplicates are masked out downstream via "weight".
                    pad = np.resize(order, self.batch_size - n_real)
                    chunk = np.concatenate([chunk, pad])
            batches.append((chunk, n_real))

        rows = self._local_rows()

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        error: list = []

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for chunk, n_real in batches:
                        if stop.is_set():
                            return
                        padded = n_real < len(chunk)
                        local = chunk[rows]
                        samples = list(pool.map(self.dataset.__getitem__,
                                                local))
                        batch = {
                            k: np.stack([s[k] for s in samples])
                            for k in samples[0]
                        }
                        if padded:
                            w = np.zeros(len(chunk), np.float32)
                            w[:n_real] = 1.0
                            batch["weight"] = w[rows]
                        out_q.put(batch)
            except BaseException as e:  # propagate to the consumer
                error.append(e)
            finally:
                out_q.put(None)  # always unblock the consumer

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    if error:
                        raise RuntimeError(
                            "HostLoader worker failed") from error[0]
                    return
                yield batch
        finally:
            stop.set()
            # drain so the producer can exit
            while producer.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
