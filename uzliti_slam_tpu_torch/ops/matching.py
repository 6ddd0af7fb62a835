"""Descriptor bit packing: 256-bit binary descriptors as (..., 32) uint8.

The port's counterpart of ``pack_bits``/``unpack_bits`` in
``uzliti_slam_tpu/ops/matching.py``: LSB first, bit i of byte b is test
8·b + i.  The Hamming matching of the same module comes with the keyframe
step.
"""

from __future__ import annotations

import torch

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
