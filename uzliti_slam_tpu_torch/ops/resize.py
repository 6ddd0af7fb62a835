"""Linear image resize with the reference's antialiasing.

The JAX package shrinks images with ``jax.image.resize(img, shape,
"linear")``, whose default is ``antialias=True``: each output sample is a
triangle filter widened by the inverse scale when downsampling, its
weights normalised per output sample, and samples whose centre falls
outside the input get weight 0.  Neither ``F.interpolate(mode="bilinear")``
nor its antialiased variant is that filter at the borders.  So this module
builds the same separable weight matrices as JAX's ``compute_weight_mat``
(``jax/_src/image/scale.py``), in float32 and in its order of operations,
and contracts them with two matrix products, as JAX does with one einsum.
The matrices depend only on the shapes and are cached per (input size,
output size, device).
"""

from __future__ import annotations

import torch

_weights: dict = {}


def weight_matrix(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) float32 weights of a linear, antialiased resize
    along one axis (translation 0, scale out_size / in_size).

    Follows the reference's compiled form, as XLA on the CPU emits it: the
    sample position is one fused multiply-add, fma(i + 0.5, fl(1/scale),
    -0.5), and the division by the kernel's width a multiplication by its
    float32 reciprocal (the eager form differs by up to 2e-5 in a weight)."""
    device = torch.device(device)
    key = (in_size, out_size, device)
    if key not in _weights:
        f32 = torch.float32
        inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=f32)
        kernel_scale = torch.tensor(max(1.0 / (out_size / in_size), 1.0), dtype=f32)
        centre = torch.arange(out_size, dtype=f32) + 0.5
        sample_f = (centre.double() * inv_scale.double() - 0.5).to(f32)
        dist = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None])
        x = dist * (torch.tensor(1.0, dtype=f32) / kernel_scale)
        w = torch.clamp(1 - torch.abs(x), min=0)
        total = torch.sum(w, dim=0, keepdim=True)
        eps = torch.finfo(f32).eps
        w = torch.where(torch.abs(total) > 1000.0 * eps,
                        w / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
        inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
        _weights[key] = torch.where(inside[None, :], w, 0.0).to(device)
    return _weights[key]


def resize_linear(img: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """(..., H, W) float32 -> (..., h, w), as ``jax.image.resize(img, (h, w),
    "linear")``; an axis whose size does not change is left as it is."""
    h_in, w_in = img.shape[-2:]
    h, w = shape
    out = img
    if h != h_in:
        out = torch.matmul(weight_matrix(h_in, h, img.device).T, out)
    if w != w_in:
        out = torch.matmul(out, weight_matrix(w_in, w, img.device))
    return out
