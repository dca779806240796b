"""Host loader: batches of the synthetic corpus as tensors on one device.

The single-device counterpart of ``repro/data/loader.py::ShardedLoader``
(no mesh, no prefetch thread): batch ``step`` is regenerated from the
counter-based source, so a resumed run continues with the same data by
setting ``step``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.data.synthetic import SyntheticLM


class SyntheticLoader:
    def __init__(self, source: SyntheticLM, batch_size: int, device: torch.device,
                 start_step: int = 0):
        self.source = source
        self.batch_size = batch_size
        self.device = device
        self.step = start_step

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        b = self.source.batch(self.step, self.batch_size)
        self.step += 1
        return {k: torch.as_tensor(v).long().to(self.device) for k, v in b.items()}
