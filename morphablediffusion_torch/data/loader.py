"""Threaded prefetching batch loader with per-process sharding.

The PyTorch port's own copy of the JAX package's `data/loader.py`: a seeded
permutation per epoch of which each process walks its own strided shard
(`order[process_index::process_count]`, the DistributedSampler contract; a
process is a rank, so `batch_size` is per rank), worker threads that
assemble items
(image decodes and a mesh load per item; PIL and numpy release the GIL), and
a bounded queue that keeps batches ready so the card does not wait on the
host.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from morphablediffusion_torch.data.common import collate


class _ProducerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + epoch).permutation(n)
        return order[self.process_index :: self.process_count]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.epochs()

    def epochs(self) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite batch stream across epochs.

        The returned generator owns one daemon producer thread; call
        `.close()` (or exhaust/GC it) to stop the producer — callers that
        need batches repeatedly (e.g. periodic validation) must reuse ONE
        iterator, not create a fresh one per use.
        """
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            epoch = 0
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    while not stop.is_set():
                        idx = self._epoch_indices(epoch)
                        for lo in range(0, len(idx), self.batch_size):
                            if stop.is_set():
                                return
                            chunk = idx[lo : lo + self.batch_size]
                            if len(chunk) < self.batch_size:
                                continue  # the last partial batch is dropped
                            items = list(
                                pool.map(self.dataset.__getitem__, chunk)
                            )
                            if stop.is_set():
                                return
                            out_q.put(collate(items))
                        epoch += 1
            except BaseException as e:  # surface to the consumer, don't deadlock
                out_q.put(_ProducerError(e))

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if isinstance(batch, _ProducerError):
                    raise RuntimeError("data producer thread failed") from batch.exc
                yield batch
        finally:
            stop.set()
            # unblock a producer stuck on a full queue so the thread can exit
            try:
                out_q.get_nowait()
            except queue.Empty:
                pass
