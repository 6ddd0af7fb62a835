"""Place recognition by the binary GIST, and the pair gate of the keyframe
step.

The port's counterpart of ``uzliti_slam_tpu/recognition/recognizer.py``
for the default method ("gist"): a fixed-capacity bank of one 256-bit
GIST per node slot, queried for the k nearest nodes within a Hamming
distance that lie at least ``min_dt`` seconds away (K16's ``gist_topk``),
and ``mask_existing_pairs``, which drops candidate pairs that already
have an edge.  The feature-set, repository and bag-of-words banks are not
ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from uzliti_slam_tpu_torch import _device
from uzliti_slam_tpu_torch.graph.state import set_row
from uzliti_slam_tpu_torch.kernels import ops as kops

MIN_TIME_SEPARATION = 5.0  # seconds


class GistBank(NamedTuple):
    desc: torch.Tensor    # (N, 32) uint8 binary GIST per node slot
    stamp: torch.Tensor   # (N,) float32
    valid: torch.Tensor   # (N,) bool


def scalar(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` as a () tensor on ``device``: a tensor is moved, a number is
    filled in on the device (no host-to-device copy, no synchronisation)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).reshape(())
    return torch.full((), x, dtype=dtype, device=device)


def gist_bank_init(capacity: int, device=None) -> GistBank:
    device = _device.resolve(device)
    return GistBank(desc=torch.zeros(capacity, 32, dtype=torch.uint8, device=device),
                    stamp=torch.zeros(capacity, dtype=torch.float32, device=device),
                    valid=torch.zeros(capacity, dtype=torch.bool, device=device))


def gist_bank_add(bank: GistBank, slot, desc: torch.Tensor, stamp) -> GistBank:
    """The bank with ``desc`` and ``stamp`` written at ``slot``, or unchanged
    where ``slot`` < 0.  Functional."""
    dev = bank.desc.device
    slot = scalar(slot, torch.int64, dev)
    ok = slot >= 0
    idx = torch.clamp(slot, min=0)
    return GistBank(desc=set_row(bank.desc, idx, ok, desc),
                    stamp=set_row(bank.stamp, idx, ok, scalar(stamp, torch.float32, dev)),
                    valid=set_row(bank.valid, idx, ok, True))


def gist_bank_remove(bank: GistBank, slot) -> GistBank:
    slot = scalar(slot, torch.int64, bank.desc.device)
    return bank._replace(valid=set_row(bank.valid, torch.clamp(slot, min=0), slot >= 0, False))


def gist_query(bank: GistBank, desc: torch.Tensor, stamp, k: int = 10, max_dist: float = 60.0,
               min_dt: float = MIN_TIME_SEPARATION):
    """The k nearest GIST entries within Hamming ``max_dist``, excluding
    invalid entries and entries within ``min_dt`` of ``stamp`` (K16).
    Returns (slots (k,) int32, dists (k,) float32, ok (k,) bool)."""
    dev = bank.desc.device
    return kops.gist_topk(desc.contiguous(), bank.desc.contiguous(), bank.stamp.contiguous(),
                          bank.valid.contiguous(), scalar(stamp, torch.float32, dev), k,
                          float(min_dt), float(max_dist))


def mask_existing_pairs(e_from, e_to, e_valid, cand_a, cand_b) -> torch.Tensor:
    """False for each candidate pair (a, b) that an edge of ``e_valid``
    already joins, in either direction."""
    pa, pb = torch.minimum(cand_a, cand_b), torch.maximum(cand_a, cand_b)
    ea, eb = torch.minimum(e_from, e_to), torch.maximum(e_from, e_to)
    dup = (pa[:, None] == ea[None, :]) & (pb[:, None] == eb[None, :]) & e_valid[None, :]
    return ~torch.any(dup, dim=-1)
