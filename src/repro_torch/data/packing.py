"""Sequence packing: concatenate variable-length documents into fixed-length
training rows with segment ids, and a loss mask that drops cross-document
prediction targets.

The port's own copy of ``repro/data/packing.py`` (numpy only). Packing is
greedy first-fit in arrival order (deterministic). As in the JAX package,
the model reads ``loss_mask`` (``api.model_loss``) and not
``segment_ids``: the documents of a packed row attend to one another, and
the MoD router is segment-agnostic (routing weights are per token). The
loader never packs; a source that packs yields these rows as its batches.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np


def pack_documents(
    docs: Sequence[np.ndarray], seq_len: int, pad_id: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields dict(tokens, labels, segment_ids, loss_mask) rows: int32
    ``(seq_len,)`` tokens, labels (the tokens shifted by one) and segment
    ids (1, 2, ... by document, 0 on padding), and an f32 mask that is 1
    where a label continues its token's document."""
    buf_toks: List[int] = []
    buf_segs: List[int] = []
    seg = 1
    for doc in docs:
        d = list(map(int, doc))
        while d:
            space = seq_len + 1 - len(buf_toks)
            take, d = d[:space], d[space:]
            buf_toks.extend(take)
            buf_segs.extend([seg] * len(take))
            if len(buf_toks) == seq_len + 1:
                yield _emit(buf_toks, buf_segs)
                buf_toks, buf_segs = [], []
        seg += 1
    if buf_toks:
        pad = seq_len + 1 - len(buf_toks)
        buf_toks.extend([pad_id] * pad)
        buf_segs.extend([0] * pad)
        yield _emit(buf_toks, buf_segs)


def _emit(toks: List[int], segs: List[int]) -> Dict[str, np.ndarray]:
    t = np.asarray(toks, np.int32)
    s = np.asarray(segs, np.int32)
    same_seg = (s[1:] == s[:-1]) & (s[1:] > 0)
    return {
        "tokens": t[:-1],
        "labels": t[1:],
        "segment_ids": s[:-1],
        "loss_mask": same_seg.astype(np.float32),
    }
