"""Host loader: a rank's rows of the synthetic corpus's batches, as
tensors on its device.

:class:`ShardedLoader` is the counterpart of ``repro/data/loader.py::
ShardedLoader``: a rank of a mesh receives its rows of global batch
``step`` (the batch over the data-parallel ranks, ``ShardCtx.data_rank``
of ``data_shards`` parts, cut on the dim ``sharding.batch_placement``
gives each leaf: M-RoPE positions ``(3, B, S)`` on dim 1), a background
thread keeping JAX's prefetch depth of 2 batches ready on the host.
Without a mesh the rank is the whole batch (one process). Batch ``step``
is regenerated from the counter-based source, so a resumed run continues
with the same data by setting ``step``. With ``microbatches = n`` the JAX
step splits the *global* batch into n microbatches before sharding them,
so rank r's microbatch i is its slice of global microbatch i, not the
i-th split of its own contiguous rows: the rank's batch is laid out so
that the train loop's split of it gives exactly those slices.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.data.synthetic import SyntheticLM
from repro_torch.distributed import sharding as SH

Batch = Dict[str, torch.Tensor]


def rank_rows(batch_size: int, data_shards: int, data_rank: int, microbatches: int = 1
              ) -> np.ndarray:
    """The global batch rows a data-parallel rank holds, in its order: for
    each global microbatch in turn, the rank's contiguous part of it."""
    n, d = int(microbatches), int(data_shards)
    if batch_size % (n * d):
        raise ValueError(f"global batch {batch_size} is not divisible by microbatches {n} x "
                         f"data-parallel ranks {d}")
    mb, part = batch_size // n, batch_size // (n * d)
    return np.concatenate([np.arange(i * mb + data_rank * part, i * mb + (data_rank + 1) * part)
                           for i in range(n)])


def _host_tensor(v: Any) -> torch.Tensor:
    """A source's batch leaf as a CPU tensor: integer leaves (tokens,
    labels, segment ids) as int64, float leaves (a packed row's
    ``loss_mask``) as they are."""
    v = np.asarray(v)
    return torch.as_tensor(v).long() if v.dtype.kind in "iub" else torch.as_tensor(v)


class ShardedLoader:
    """A rank's rows of a source's global batches (the synthetic corpus's,
    or any ``source.batch(step, batch_size)``), prefetched.

    ``spmd`` (a ``ShardCtx`` with a mesh) picks the rank's rows; without
    one the rank is the whole batch. ``transform(step, batch)`` may add to
    the global host batch before the rows are cut (the enc-dec and VLM
    stub frontends draw their global inputs there). Setting ``step``
    restarts the stream there (a resumed run)."""

    def __init__(self, source: SyntheticLM, batch_size: int, device: torch.device,
                 spmd: Any = None, microbatches: int = 1, start_step: int = 0,
                 prefetch: int = 2, transform: Optional[Callable[[int, Batch], Batch]] = None):
        d, r, self.mesh = 1, 0, None
        if spmd is not None and spmd.mesh is not None:
            d, r, self.mesh = spmd.data_shards, spmd.data_rank, spmd.mesh
        self.source, self.batch_size, self.device = source, batch_size, device
        self.rows = torch.as_tensor(rank_rows(batch_size, d, r, microbatches))
        self.transform, self.prefetch = transform, prefetch
        self._step = start_step
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._q: "queue.Queue" = queue.Queue()

    def host_batch(self, step: int) -> Batch:
        """This rank's rows of global batch ``step``, as CPU tensors."""
        b: Batch = {k: _host_tensor(v) for k, v in self.source.batch(step, self.batch_size).items()}
        if self.transform is not None:
            b = self.transform(step, b)
        if self.mesh is None:
            return b
        specs = SH.batch_placement(b, self.mesh)
        return {k: v.index_select(next(i for i, ax in enumerate(specs[k]) if ax is not None),
                                  self.rows)
                for k, v in b.items()}

    def _producer(self, step: int, stop: threading.Event, q: "queue.Queue") -> None:
        while not stop.is_set():
            try:
                item = (step, self.host_batch(step), None)
            except Exception as e:  # noqa: BLE001 -- re-raised by __next__
                item = (step, None, e)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if item[2] is not None:
                return
            step += 1

    @property
    def step(self) -> int:
        """The step of the next batch."""
        return self._step

    @step.setter
    def step(self, value: int) -> None:
        self.close()
        self._step = int(value)

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        if self._thread is None:
            self._stop = threading.Event()
            self._q = queue.Queue(maxsize=self.prefetch)
            self._thread = threading.Thread(target=self._producer,
                                            args=(self._step, self._stop, self._q), daemon=True)
            self._thread.start()
        step, batch, err = self._q.get()
        if err is not None:
            self.close()
            raise err
        self._step = step + 1
        return {k: v.to(self.device) for k, v in batch.items()}

    def close(self) -> None:
        """Stop the prefetch thread (the next batch starts it again)."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
