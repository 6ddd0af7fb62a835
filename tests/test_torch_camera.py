"""The port's pinhole camera (``frontend/camera.py``) and ``lie.roll_of``
against the JAX package's, compiled, on the CPU.

Inputs are made with numpy from a seed; the JAX functions run under
``jax.jit`` (the reference's keyframe step is compiled).  Tolerance 1e-5:
the same float32 arithmetic, which XLA may contract into fused
multiply-adds (a few ulps of a pixel coordinate or a metre).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.frontend import camera as jcam
from uzliti_slam_tpu.ops import lie as jlie
from uzliti_slam_tpu_torch.frontend import camera as tcam
from uzliti_slam_tpu_torch.ops import lie as tlie

TOL = 1e-5
DIST = dict(k1=-0.12, k2=0.03, p1=0.002, p2=-0.001)


def _cams(distorted: bool):
    kw = DIST if distorted else {}
    j = jcam.PinholeCamera(fx=jnp.float32(130.0), fy=jnp.float32(128.5), cx=jnp.float32(80.0),
                           cy=jnp.float32(59.5), width=160, height=120, **kw)
    t = tcam.PinholeCamera(fx=130.0, fy=128.5, cx=80.0, cy=59.5, width=160, height=120, **kw)
    return j, t


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b,
                               rtol=0, atol=tol)


def test_backproject_and_project_match_jax():
    jc, tc = _cams(False)
    rng = np.random.default_rng(0)
    u, v = (rng.uniform(0, 160, 200).astype(np.float32), rng.uniform(0, 120, 200).astype(np.float32))
    z = rng.uniform(0.2, 6.0, 200).astype(np.float32)
    pj = jax.jit(jcam.backproject)(jc, u, v, z)
    pt = tcam.backproject(tc, torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(z))
    _close(pj, pt)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.1
    pts[0, 2] = 0.0                                   # the 1e-9 guard
    for a, b in zip(jax.jit(jcam.project)(jc, pts), tcam.project(tc, torch.from_numpy(pts))):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6, atol=TOL)


def test_default_kinect_is_the_reference_intrinsics():
    j, t = jcam.default_kinect(), tcam.default_kinect()
    assert (float(j.fx), float(j.fy), float(j.cx), float(j.cy), j.width, j.height) == tuple(t[:6])


def test_undistort_points_matches_jax():
    jc, tc = _cams(True)
    rng = np.random.default_rng(1)
    u, v = (rng.uniform(0, 160, 300).astype(np.float32), rng.uniform(0, 120, 300).astype(np.float32))
    for a, b in zip(jax.jit(jcam.undistort_points)(jc, u, v),
                    tcam.undistort_points(tc, torch.from_numpy(u), torch.from_numpy(v))):
        _close(a, b, 1e-4)          # pixels: 1e-5 of a 160-px coordinate is ~1 ulp
    # the fixed point inverts the distortion
    xd, yd = tcam.distort_normalized(tc, *(t / 130.0 for t in (torch.zeros(1), torch.zeros(1))))
    assert float(xd.abs().max()) == 0.0 and float(yd.abs().max()) == 0.0


@pytest.mark.parametrize("nearest", [False, True], ids=["bilinear", "nearest"])
def test_rectify_image_matches_jax(nearest):
    jc, tc = _cams(True)
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (120, 160)).astype(np.float32)
    rj = jax.jit(lambda c, x: jcam.rectify_image(c, x, nearest=nearest))(jc, img)
    rt = tcam.rectify_image(tc, torch.from_numpy(img), nearest=nearest)
    # XLA contracts the sample position x·fx + cx into a fused multiply-add,
    # so a position may differ by an ulp (< 2e-5 px at 160 px); neighbours of
    # this noise image differ by up to 255, so a bilinear value moves by up
    # to 255 × 2e-5 (nearest sampling: exact unless a position sits on .5)
    _close(rj, rt, 255 * 2e-5)
    # a camera batch gives each camera's rectification
    both = tcam.rectify_image(tc, torch.from_numpy(np.stack([img, img[::-1].copy()])),
                              nearest=nearest)
    assert torch.equal(both[0], rt)


def test_backproject_image_matches_jax():
    jc, tc = _cams(False)
    depth = np.random.default_rng(3).uniform(0.5, 5.0, (120, 160)).astype(np.float32)
    _close(jax.jit(jcam.backproject_image)(jc, depth),
           tcam.backproject_image(tc, torch.from_numpy(depth)))


def test_roll_of_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _close(jax.jit(jlie.roll_of)(q), tlie.roll_of(torch.from_numpy(q)), 1e-6)
    # the forward camera's extrinsic: roll -π/2 (optical y points down)
    from uzliti_slam_tpu.io import simulator as jsim
    from uzliti_slam_tpu_torch.io import simulator as tsim

    ext = tsim.cam_extrinsic(device="cpu")
    np.testing.assert_allclose(np.asarray(jsim.cam_extrinsic()), ext.numpy(), atol=1e-7)
    assert float(tlie.roll_of(tlie.pose_q(ext))) == pytest.approx(-np.pi / 2, abs=1e-6)
