"""Threaded prefetching data loader (host pipeline).

Replaces torch DataLoader workers (reference: base_trainer.py:20-25,
trainer_SID.py:49): worker threads run dataset __getitem__ (NumPy, GIL
released in BLAS/IO), a bounded queue smooths latency, and batches are
stacked contiguous so device_put is a single transfer. Seed discipline
mirrors the reference's worker_init_fn: each worker reseeds its thread-local
dataset RNG deterministically from (base_seed, epoch, worker); batches are
assigned to workers round-robin, so multi-worker epochs are reproducible
regardless of thread scheduling.

While tracing is on (:mod:`pnnp_tpu_torch.utils.profiling`), each batch
records a ``loader.fetch`` span where it is built (by a worker, or by the
consumer without workers), with its ``collate`` a ``loader.collate`` span
inside, and a ``loader.wait`` span where the consumer waits for it. Both
carry the pass number and the batch index ``bi``; the wait also carries
``first`` (the pass's first batch), ``ready`` (built when asked) and
``built`` (batches built and not consumed, at the ask).

Under several data-parallel ranks (``shard=(rank, n)``) every rank draws the
same shuffle order (from ``seed + epoch``) and loads only its contiguous
block of each global batch's indices, rank ``r`` the ``r``-th ``1/n`` (a
batch of fewer indices wrap-padded to a multiple of ``n`` first, as
``DataParallel`` scatters an uneven batch); its workers reseed from
``(seed, epoch, rank * workers + worker)``, so no two ranks draw alike.
"""

from __future__ import annotations

import itertools
import threading
from typing import Iterator, Optional

import numpy as np

from pnnp_tpu_torch.utils.profiling import span

_PASSES = itertools.count()  # numbers the passes of every loader in the process


def collate(samples: list) -> dict:
    """Stack example dicts; image crops concatenate along the crop axis
    (the reference's dim5->4 view, trainer_SID.py:423)."""
    out = {}
    first = samples[0]
    for k, v in first.items():
        vals = [s[k] for s in samples]
        if isinstance(v, np.ndarray) and v.ndim >= 3:  # [n, p, p, c] crops
            out[k] = np.concatenate(vals, axis=0)
        elif isinstance(v, np.ndarray):
            out[k] = np.concatenate([np.atleast_1d(x) for x in vals], axis=0)
        elif isinstance(v, (int, float, np.number, bool)):
            out[k] = np.asarray(vals)
        else:
            out[k] = vals  # strings etc.
    return out


def _rank_block(b: np.ndarray, rank: int, n: int) -> np.ndarray:
    """Rank ``rank``'s contiguous ``1/n`` of the indices ``b``, wrap-padded
    to a multiple of ``n``."""
    padded = b[np.arange(len(b) + (-len(b)) % n) % len(b)]
    m = len(padded) // n
    return padded[rank * m:(rank + 1) * m]


class DataLoader:
    """Iterable over shuffled batches with background prefetch."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = True,
                 num_workers: int = 2, prefetch: int = 4, seed: int = 1997,
                 drop_last: bool = False, shard: Optional[tuple] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last
        self.shard = shard
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _index_batches(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        bs = self.batch_size
        stop = (n // bs) * bs if self.drop_last else n
        batches = [idx[i : i + bs] for i in range(0, stop, bs) if len(idx[i : i + bs])]
        if self.shard is not None:
            rank, k = self.shard
            batches = [_rank_block(b, rank, k) for b in batches]
        return batches

    def _reseed(self, worker: int):
        if hasattr(self.dataset, "reseed_worker"):
            if self.shard is not None:
                worker += self.shard[0] * max(self.num_workers, 1)
            self.dataset.reseed_worker(self.seed, self.epoch, worker)

    def _fetch(self, b, rid: dict, bi: int, worker: int) -> dict:
        """Batch ``bi`` (indices ``b``) built: its items, then ``collate``."""
        with span("loader.fetch", **rid, bi=bi, worker=worker):
            items = [self.dataset[int(i)] for i in b]
            with span("loader.collate"):
                return collate(items)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        batches = self._index_batches()
        rid = {"pass": next(_PASSES)}
        if self.num_workers == 0:
            self._reseed(0)
            for bi, b in enumerate(batches):
                with span("loader.wait", **rid, bi=bi, first=bi == 0, ready=False, built=0):
                    batch = self._fetch(b, rid, bi, 0)
                yield batch
            return

        # Static round-robin assignment (worker w takes batches w, w+nw, ...)
        # + per-(epoch, worker) RNG reseed makes multi-worker epochs
        # deterministic regardless of thread scheduling — the analog of
        # torch's worker_init_fn (reference: base_trainer.py:20-25).
        #
        # Backpressure is a Condition bounding each worker's LEAD over
        # consumption: worker w starts batch bi only once bi < yielded +
        # prefetch. Unlike a counting semaphore (which let out-of-order
        # completions tie up every permit while the worker owning the
        # next-needed batch parked on acquire — a permanent hang when
        # num_workers >= prefetch), the worker owning batch `yielded` always
        # satisfies the predicate, so the consumer can never starve; at most
        # `prefetch` computed-but-unconsumed batches exist at any time.
        results: dict = {}
        cond = threading.Condition()
        state = {"yielded": 0, "stop": False}
        prefetch = max(1, self.prefetch)

        def worker(w: int):
            self._reseed(w)
            for bi in range(w, len(batches), self.num_workers):
                with cond:
                    while not state["stop"] and bi >= state["yielded"] + prefetch:
                        cond.wait()
                    if state["stop"]:
                        return
                try:
                    batch = self._fetch(batches[bi], rid, bi, w)
                except BaseException as e:  # surface in consumer
                    batch = e
                with cond:
                    results[bi] = batch
                    cond.notify_all()
                if isinstance(batch, BaseException):
                    return  # siblings keep draining; consumer raises at bi

        threads = [
            threading.Thread(target=worker, args=(w,), daemon=True)
            for w in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        try:
            for bi in range(len(batches)):
                owner = threads[bi % self.num_workers]
                with span("loader.wait", **rid, bi=bi, first=bi == 0, ready=bi in results,
                          built=len(results)), cond:
                    while bi not in results:
                        if not owner.is_alive():
                            raise RuntimeError(
                                "DataLoader worker died without delivering "
                                f"batch {bi}")
                        cond.wait(timeout=0.1)
                    batch = results.pop(bi)
                    state["yielded"] = bi + 1
                    cond.notify_all()
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            with cond:
                state["stop"] = True
                cond.notify_all()
