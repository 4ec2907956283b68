"""Deterministic segment sums: each segment's rows added in order.

``index_add_`` adds with atomics on the card, so two runs may differ in
their last bits. These sums sort the rows by segment once and reduce each
run of rows in order (``torch.segment_reduce``), so that every run on
every device gives the same bits. The warp field, the pose graph, the
bundle adjustment and the spectral kNN operator share them.
"""

from __future__ import annotations

import numpy as np
import torch


def sorted_sum(values, lengths):
    """Sums of consecutive runs of ``values`` rows, one per entry of
    ``lengths`` (0 for an empty run), each run added in order:
    deterministic on every device. ``unsafe`` skips the lengths checks,
    which read back to the host; the callers count the lengths themselves."""
    return torch.segment_reduce(values, "sum", lengths=lengths, axis=0, unsafe=True)


def sorted_scatter_plan(keys: np.ndarray, num_segments: int, dev):
    """``(order, lengths, targets)`` for summing rows by ``keys`` (host
    integers in ``[0, num_segments)``) with :func:`sorted_scatter_sum`: the
    stable order (the rows of one key keep their order, as a sequential
    scatter-add adds them), the run lengths and the distinct keys."""
    keys = np.asarray(keys, np.int64)
    if keys.size and (keys.min() < 0 or keys.max() >= num_segments):
        raise ValueError(f"segment ids out of [0, {num_segments})")
    uniq, counts = np.unique(keys, return_counts=True)
    return (
        torch.as_tensor(np.argsort(keys, kind="stable"), device=dev),
        torch.as_tensor(counts, device=dev),
        torch.as_tensor(uniq, device=dev),
    )


def sorted_scatter_sum(values: torch.Tensor, plan, num_segments: int) -> torch.Tensor:
    """``zeros(num_segments, ...).at[keys].add(values)`` with the rows of
    each key added in order: a sorted segment reduction, so the same bits
    on every run of every device (``index_add_`` adds with atomics on the
    card)."""
    order, lengths, targets = plan
    out = values.new_zeros((num_segments,) + values.shape[1:])
    return out.index_copy_(0, targets, sorted_sum(values[order], lengths))
