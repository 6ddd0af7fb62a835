"""Descriptor matching: binary 256-bit descriptors as (..., 32) uint8 by
Hamming distance, float descriptors (the "sift" family) by L2.

The port's counterpart of ``uzliti_slam_tpu/ops/matching.py``: bit
packing (LSB first, bit i of byte b is test 8·b + i), the Hamming
distance matrix, the 2-NN with masked pairs at 1e9, Lowe's ratio test and
``match_descriptors``.  The reference computes the distances as an int8
matrix product on unpacked bits (the TPU's form); the port keeps the
descriptors packed and matches them with kernel K16 (``hamming_top2``:
XOR and popcount, each query's scan split over 8 lanes whose (best,
second) keys merge by shuffles, no distance matrix), all candidates of a
keyframe in one launch.  ``hamming_matrix``
and ``knn_match`` stay as the reference's plain functions.  Ties keep the
lower index, as XLA's ``top_k``.  Float descriptors go through kernel K30
(``l2_top2``: the reference's ‖a‖² + ‖b‖² − 2·a·bᵀ in float32 tiles, a
running best and second per query, no distance matrix); ``l2_matrix`` is
the reference's plain function.
"""

from __future__ import annotations

import math

import torch

from uzliti_slam_tpu_torch.kernels import ops as kops

DESCRIPTOR_BYTES = 32
DESCRIPTOR_BITS = DESCRIPTOR_BYTES * 8


def _shifts(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(..., B) uint8 -> (..., 8*B) float32 bits in {0, 1} (LSB first)."""
    bits = (packed[..., :, None] >> _shifts(packed.device)) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8).to(torch.float32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8*B) {0, 1} -> (..., B) uint8 (LSB first)."""
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8).to(torch.uint8)
    return torch.sum(b << _shifts(bits.device), dim=-1, dtype=torch.uint8)


def hamming_matrix(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances of unpacked bits: bits_a (Na, D), bits_b
    (..., Nb, D) in {0, 1} -> (..., Na, Nb) float32, as |a| + |b| - 2 a·bᵀ
    (exact: every partial sum is an integer below 2²⁴)."""
    na = bits_a.sum(-1)[:, None]
    nb = bits_b.sum(-1)[..., None, :]
    return na + nb - 2.0 * (bits_a @ bits_b.transpose(-1, -2))


def hamming_matrix_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances of packed descriptors a (Na, 32), b (...,
    Nb, 32) -> (..., Na, Nb) float32."""
    return hamming_matrix(unpack_bits(a), unpack_bits(b))


def knn_match(dist: torch.Tensor, valid_a: torch.Tensor | None = None,
              valid_b: torch.Tensor | None = None, k: int = 2):
    """The k smallest distances of each row and their indices, ties to the
    lower index; masked rows and columns are 1e9 (not +inf), as the
    reference.  Returns (dists (..., Na, k), idx (..., Na, k))."""
    if valid_b is not None:
        dist = torch.where(valid_b[..., None, :], dist, kops.MASKED)
    if valid_a is not None:
        dist = torch.where(valid_a[..., :, None], dist, kops.MASKED)
    return kops.smallest_k(dist, k)


def ratio_test(d: torch.Tensor, idx: torch.Tensor, ratio: float = 0.99,
               max_dist: float | None = None):
    """Lowe's ratio test on 2-NN results: (best index, best <= ratio·second
    [& best <= max_dist]), compared in float32."""
    best, second = d[..., 0], d[..., 1]
    ok = best <= ratio * second
    if max_dist is not None:
        ok = ok & (best <= max_dist)
    return idx[..., 0], ok


def match_against_bank(desc: torch.Tensor, valid: torch.Tensor, bank: torch.Tensor,
                       bank_valid: torch.Tensor, slots: torch.Tensor, ratio: float,
                       max_dist: float | None = None):
    """Match ``desc`` (Na, 32) against the stored descriptors of each node
    ``slots[c]`` of ``bank`` (N, F, 32) (validity ``bank_valid`` (N, F)):
    K16, one launch for all C slots.  Returns (match_idx, ok, best_dist),
    each (C, Na)."""
    return kops.hamming_top2(desc.contiguous(), bank.contiguous(), bank_valid.contiguous(),
                             slots.to(torch.int32).contiguous(), valid.contiguous(),
                             float(ratio), math.inf if max_dist is None else float(max_dist))


def match_descriptors(desc_a: torch.Tensor, desc_b: torch.Tensor,
                      valid_a: torch.Tensor | None = None, valid_b: torch.Tensor | None = None,
                      ratio: float = 0.99, max_dist: float | None = None):
    """Hamming 2-NN and ratio test of packed descriptors desc_a (Na, 32)
    against desc_b (Nb, 32) or a batch (C, Nb, 32) (K16).  Returns
    (match_idx, ok, best_dist), each (Na,) or (C, Na); ``ok`` also requires
    ``valid_a``, as the reference's."""
    bank = desc_b if desc_b.dim() == 3 else desc_b[None]
    C, Nb = bank.shape[:2]
    dev = desc_a.device
    if valid_a is None:
        valid_a = torch.ones(desc_a.shape[0], dtype=torch.bool, device=dev)
    vb = (torch.ones(C, Nb, dtype=torch.bool, device=dev) if valid_b is None
          else valid_b.reshape(C, Nb))
    out = match_against_bank(desc_a, valid_a, bank, vb,
                             torch.arange(C, dtype=torch.int32, device=dev), ratio, max_dist)
    return out if desc_b.dim() == 3 else tuple(x[0] for x in out)


def l2_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared-L2 distances of float descriptors a (Na, D), b (Nb,
    D): ‖a‖² + ‖b‖² − 2·a·bᵀ, clamped at 0 (cancellation), in float32."""
    na = torch.sum(a * a, dim=-1, keepdim=True)
    nb = torch.sum(b * b, dim=-1, keepdim=True)
    return torch.clamp(na + nb.transpose(-1, -2) - 2.0 * (a @ b.transpose(-1, -2)), min=0.0)


def match_descriptors_l2(desc_a: torch.Tensor, desc_b: torch.Tensor,
                         valid_a: torch.Tensor | None = None,
                         valid_b: torch.Tensor | None = None, ratio: float = 0.8,
                         max_dist: float | None = None):
    """Float-descriptor matching (K30): squared-L2 2-NN of desc_a (Na, D)
    against desc_b (Nb, D), then the ratio test on squared distances — the
    ratio (Lowe's 0.8, on Euclidean distances) and ``max_dist`` are squared
    first.  Returns (match_idx (Na,) int32, ok (Na,) bool, best squared
    distance (Na,)); ``ok`` also requires ``valid_a``."""
    dev = desc_a.device
    if valid_a is None:
        valid_a = torch.ones(desc_a.shape[0], dtype=torch.bool, device=dev)
    if valid_b is None:
        valid_b = torch.ones(desc_b.shape[0], dtype=torch.bool, device=dev)
    return kops.l2_top2(desc_a.contiguous(), desc_b.contiguous(), valid_a.contiguous(),
                        valid_b.contiguous(), ratio * ratio,
                        math.inf if max_dist is None else max_dist * max_dist)
