"""Host-sharded, threaded, prefetching batch loader (the port's copy of
``vadcl_tpu/data/loader.py``; ``tests/test_torch_port_data.py`` guards it
against drift).

Each host takes a strided slice of an epoch-seeded global permutation
(seed+epoch generator, pad to divisible, rank-strided slice: the semantics
of a distributed sampler), decodes clips on a thread pool, and prefetches
assembled uint8 batches.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from vadcl_tpu_torch.data.dataset import ClipDataset


class HostDataLoader:
    def __init__(
        self,
        dataset: ClipDataset,
        batch_size: int,  # per-host global batch (all local devices)
        seed: int = 0,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 8,
        prefetch: int = 2,
        host_id: int = 0,
        num_hosts: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.host_id = host_id
        self.num_hosts = num_hosts

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.seed * 1_000_003 + epoch)
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        # pad to a multiple of num_hosts, then strided host slice
        pad = (-len(idx)) % self.num_hosts
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
        return idx[self.host_id :: self.num_hosts]

    def steps_per_epoch(self) -> int:
        n = len(self._epoch_indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int, start_iter: int = 0) -> Iterator[np.ndarray]:
        """Yields (batch_size, frame_num, H, W, C) uint8 batches
        (normalized to [0, 1] on device by the train step / scorer).

        ``start_iter`` fast-forwards past the first N batches of the epoch's
        deterministic permutation (mid-epoch resume: the sampler continues
        exactly where a crashed run left off)."""
        idx = self._epoch_indices(epoch)
        if self.drop_last:
            idx = idx[: len(idx) // self.batch_size * self.batch_size]
        if start_iter:
            idx = idx[start_iter * self.batch_size :]
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that honors `stop`: an abandoned iterator must not
            # leave the producer blocked on a full queue forever
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        error = []

        def producer():
            try:
                # num_workers=0 means decode synchronously (torch DataLoader
                # semantics); ThreadPoolExecutor rejects 0 workers
                with ThreadPoolExecutor(max(1, self.num_workers)) as pool:
                    for i in range(0, len(idx), self.batch_size):
                        if stop.is_set():
                            return
                        chunk = idx[i : i + self.batch_size]
                        clips = list(pool.map(self.dataset.get_clip, chunk))
                        if not put(np.stack(clips)):
                            return
            except Exception as e:  # surface decode errors to the consumer
                error.append(e)
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                try:
                    batch = out_q.get(timeout=1.0)
                except queue.Empty:
                    if not t.is_alive():
                        break
                    continue
                if batch is None:
                    break
                yield batch
            if error:
                raise error[0]
        finally:
            stop.set()
