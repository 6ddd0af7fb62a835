"""Port parity: the joint bilateral depth filter (K17's plain version on
the CPU) against JAX's ``joint_bilateral_filter`` compiled under
``jax.jit``, and tests/test_frontend.py's hole-filling and edge cases.

The port follows the compiled reference's arithmetic (read from its
optimized HLO and the LLVM contraction it gets): the spatial weights are
the compiled float32 constants, the colour exponent is (Δg²)·(−fl(1/200)),
w = (wd·ws)·valid', the taps are summed in the reference's dy-major order
with num as a fused multiply-add.  What is left is the exponential: XLA's
exp on one side, torch's on the other, each within an ulp or two of the
true value, so the filtered depth is held to DEPTH_ULPS units in the last
place of the reference's value (up to 4 measured on these scenes, 3 on a
VGA WallWorld frame, where 70 % of the pixels differ by an ulp or more).
Holes (depth 0 or non-finite) with no valid neighbour stay 0 on both
sides, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.ops import depth as jdepth
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import depth as tdepth

DEPTH_ULPS = 6


def _ulps(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.max(np.abs(got.astype(np.float64) - ref) / np.spacing(np.abs(ref).astype(
        np.float32)), initial=0.0))


def _scene(seed: int, h: int = 48, w: int = 64):
    """Depth 0.5-4 m with holes (0, NaN, +inf) and a step edge; a uint8 guide
    with texture and a matching edge."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 4.0, (h, w)).astype(np.float32)
    depth[:, w // 2:] += 2.0
    holes = rng.random((h, w))
    depth[holes < 0.05] = 0.0
    depth[(holes >= 0.05) & (holes < 0.07)] = np.nan
    depth[(holes >= 0.07) & (holes < 0.08)] = np.inf
    depth[10:16, 20:26] = 0.0            # a hole with no valid neighbour at its centre
    guide = rng.integers(0, 256, (h, w)).astype(np.float32)
    guide[:, w // 2:] = np.clip(guide[:, w // 2:] + 120.0, 0, 255)
    return depth, guide


def _jax_filter(depth, guide):
    return np.asarray(jax.jit(jdepth.joint_bilateral_filter)(jnp.asarray(depth), jnp.asarray(guide)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_matches_compiled_jax(seed):
    depth, guide = _scene(seed)
    ref = _jax_filter(depth, guide)
    got = tdepth.joint_bilateral_filter(torch.from_numpy(depth), torch.from_numpy(guide)).numpy()
    np.testing.assert_array_equal(got == 0, ref == 0)
    assert (ref == 0).sum() > 0 and (ref[13, 23] == 0) and np.isfinite(ref).all()
    assert _ulps(got, ref) <= DEPTH_ULPS


def _special_scene(case: str):
    """``_scene(5)`` with depths -1 and -0 beside its 0, NaN and +inf holes
    (a quarter of them on the image border), under its uint8 guide or under
    a fractional guide (uint8 + a uniform fraction: K17 takes expf at each
    tap there, not its colour table)."""
    depth, guide = _scene(5)
    rng = np.random.default_rng(6)
    spots = rng.random(depth.shape)
    depth[spots < 0.03] = -1.0
    depth[(spots >= 0.03) & (spots < 0.06)] = -0.0
    depth[0, ::3] = -0.0
    depth[-1, 1::4] = -1.0
    depth[::5, 0] = np.nan
    depth[2::6, -1] = np.inf
    if case == "fractional_guide":
        guide = (guide + rng.uniform(0.0, 1.0, guide.shape)).astype(np.float32)
    return depth, guide


@pytest.mark.parametrize("case", ["negative_and_signed_zero_depths", "fractional_guide"])
def test_filter_matches_compiled_jax_on_special_depths_and_guides(case):
    depth, guide = _special_scene(case)
    ref = _jax_filter(depth, guide)
    got = tdepth.joint_bilateral_filter(torch.from_numpy(depth), torch.from_numpy(guide)).numpy()
    np.testing.assert_array_equal(got == 0, ref == 0)
    assert (ref == 0).sum() > 0 and np.isfinite(ref).all() and np.isfinite(got).all()
    assert not np.signbit(got).any()
    assert _ulps(got, ref) <= DEPTH_ULPS


def test_filter_on_a_camera_batch_matches_per_camera():
    scenes = [_scene(s) for s in (3, 4)]
    depth = torch.from_numpy(np.stack([d for d, _ in scenes]))
    guide = torch.from_numpy(np.stack([g for _, g in scenes]))
    got = tdepth.joint_bilateral_filter(depth, guide)
    for c in range(2):
        assert torch.equal(got[c], tdepth.joint_bilateral_filter(depth[c], guide[c]))
        assert _ulps(got[c].numpy(), _jax_filter(*scenes[c])) <= DEPTH_ULPS


def test_spatial_weights_are_the_compiled_constants():
    # the constants of the reference's optimized HLO (uzliti_slam_tpu/ops/depth.py)
    compiled = {8: 0.169013306, 5: 0.329192966, 4: 0.411112279, 2: 0.641180396, 1: 0.800737381,
                0: 1.0}
    for (dy, dx), w in zip(kops.bilateral_taps(), kops.bilateral_spatial()):
        assert np.float32(w) == np.float32(compiled.get(dy * dy + dx * dx, w)), (dy, dx)
    assert kops.bilateral_spatial()[12] == 1.0 and kops.NEG_INV_2SC2 == -float(np.float32(0.005))


def test_fills_holes():
    depth = np.full((40, 40), 2.0, np.float32)
    depth[20, 20] = 0.0
    guide = np.full((40, 40), 100.0, np.float32)
    got = tdepth.joint_bilateral_filter(torch.from_numpy(depth), torch.from_numpy(guide)).numpy()
    assert abs(float(got[20, 20]) - 2.0) < 0.01
    assert _ulps(got, _jax_filter(depth, guide)) <= DEPTH_ULPS


def test_respects_edges():
    depth = np.concatenate([np.full((40, 20), 1.0), np.full((40, 20), 3.0)], axis=1).astype(np.float32)
    guide = np.concatenate([np.full((40, 20), 0.0), np.full((40, 20), 255.0)], axis=1).astype(
        np.float32)
    got = tdepth.joint_bilateral_filter(torch.from_numpy(depth), torch.from_numpy(guide)).numpy()
    assert abs(float(got[20, 5]) - 1.0) < 0.01 and abs(float(got[20, 35]) - 3.0) < 0.01
    assert _ulps(got, _jax_filter(depth, guide)) <= DEPTH_ULPS
