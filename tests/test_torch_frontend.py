"""The keyframe front-end as a whole: the port's
``pipeline.keyframe_frontend`` against what the JAX package's compiled
``process_keyframe`` stores for a first keyframe (slot 0 of ``desc``,
``desc_valid``, ``points``, ``scans`` and the GIST bank), on the CPU.

One WallWorld frame, 64 features, 90 scan bins, depth refinement off and
on (the default); one camera, and the front + rear rig of
``tests/test_multicam.py`` (the rear camera sees a flat grey image and no
depth).  Held: validity, GIST and
scan exactly (the scan up to a bin moved by an ulp of bearing, as in
``test_torch_scan.py``), descriptors bit for bit at level 0 and ≥ 99.5 %
of the valid keypoints' bits overall (``test_torch_features.py``), points
within 1e-5 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu import pipeline as jpipe
from uzliti_slam_tpu.config import FeatureExtractionConfig as JFE
from uzliti_slam_tpu.config import SlamConfig as JCfg
from uzliti_slam_tpu.io import simulator as jsim
from uzliti_slam_tpu.ops import lie as jlie
from uzliti_slam_tpu_torch import pipeline as tpipe
from uzliti_slam_tpu_torch.config import FeatureExtractionConfig as TFE
from uzliti_slam_tpu_torch.config import SlamConfig as TCfg
from uzliti_slam_tpu_torch.io import simulator as tsim
from uzliti_slam_tpu_torch.ops import scan as tscan

FEATS, BINS = 64, 90
PTS_ATOL = 1e-5
MIN_EQUAL_BITS = 0.995


def _rig(n_cams: int):
    front = jsim.cam_extrinsic()
    if n_cams == 1:
        return front
    rear = jlie.pose_compose(jlie.pose2_to_pose(jnp.array([0.0, 0.0, np.pi])), front)
    return jnp.stack([front, rear])


def _inputs(n_cams: int):
    world = jsim.WallWorld(img_h=120, img_w=160)
    fr = jsim.simulate_sequence(world, n_frames=4, odom_drift=0.02, length=2.0)[1]
    if n_cams == 1:
        return world, fr, fr["image"], fr["depth"]
    img = np.stack([fr["image"], np.full_like(fr["image"], 30)])
    dep = np.stack([fr["depth"], np.zeros_like(fr["depth"])])
    return world, fr, img, dep


@pytest.mark.parametrize("n_cams", [1, 2], ids=["one_camera", "front_rear_rig"])
def test_frontend_matches_process_keyframe(n_cams):
    world, fr, img, dep = _inputs(n_cams)
    pose = _rig(n_cams)
    jcfg = JCfg(node_capacity=8, edge_capacity=32, feats_per_node=FEATS, scan_bins=BINS,
                frontend=JFE(use_depth_refinement=False))
    kf = jpipe.Keyframe(image=jnp.asarray(img), depth=jnp.asarray(dep),
                        odom_pose=jnp.asarray(fr["odom_pose"]), stamp=jnp.float32(fr["stamp"]))
    ref, _ = jpipe.process_keyframe(jpipe.init_state(jcfg), kf, world.cam, pose, jcfg)

    tcfg = TCfg(node_capacity=8, edge_capacity=32, feats_per_node=FEATS, scan_bins=BINS,
                frontend=TFE(use_depth_refinement=False))
    cam = tsim.WallWorld(img_h=120, img_w=160, tex_size=64).cam
    out = tpipe.keyframe_frontend(img, dep, cam, np.array(pose), tcfg, device="cpu")

    valid = np.asarray(ref.desc_valid[0])
    assert out.desc.shape == (FEATS, 32) and out.uv.shape == (n_cams, FEATS // n_cams, 2)
    assert valid.sum() >= FEATS // 4
    np.testing.assert_array_equal(out.pts_valid.numpy(), valid)
    np.testing.assert_array_equal(out.kp_valid.reshape(-1).numpy() & valid, valid)
    diff = np.unpackbits(out.desc.numpy() ^ np.asarray(ref.desc[0]), axis=-1)
    level0 = np.zeros((n_cams, FEATS // n_cams), bool)
    level0[:, : FEATS // n_cams // 4] = True
    level0 = level0.reshape(-1) & valid
    np.testing.assert_array_equal(diff[level0], 0)
    assert 1.0 - diff[valid].mean() >= MIN_EQUAL_BITS
    np.testing.assert_allclose(out.pts_base.numpy()[valid], np.asarray(ref.points[0])[valid],
                               rtol=0, atol=PTS_ATOL)
    ref_scan, got_scan = np.asarray(ref.scans[0]), out.scan.ranges.numpy()
    same = (ref_scan == got_scan) | (np.isinf(ref_scan) & np.isinf(got_scan))
    assert int((~same).sum()) <= 1 and np.isfinite(ref_scan).sum() >= BINS // 12
    np.testing.assert_array_equal(out.gist.numpy(), np.asarray(ref.gist.desc[0]))


def test_frontend_takes_tensors_and_float_depth():
    world, fr, img, dep = _inputs(1)
    cam = tsim.WallWorld(img_h=120, img_w=160, tex_size=64).cam
    cfg = TCfg(feats_per_node=FEATS, scan_bins=BINS, frontend=TFE(use_depth_refinement=False))
    pose = tsim.cam_extrinsic(device="cpu")
    a = tpipe.keyframe_frontend(img, dep, cam, pose, cfg, device="cpu")
    # tensors on the CPU, depth as float metres (the uint16 × 1e-3 of the wire format)
    metres = torch.from_numpy(dep.astype(np.int32)).float() * 1e-3
    b = tpipe.keyframe_frontend(torch.from_numpy(img), metres, cam, pose, cfg)
    for x, y in zip(a[:5], b[:5]):
        assert torch.equal(x, y)
    assert torch.equal(a.scan.ranges, b.scan.ranges) and torch.equal(a.gist, b.gist)


@pytest.mark.parametrize("n_cams", [1, 2], ids=["one_camera", "front_rear_rig"])
def test_refined_frontend_matches_process_keyframe(n_cams):
    """The default configuration: each camera's depth goes through the joint
    bilateral filter (K17's plain version here) before the keypoints' depth
    lookup and the scan.  The filtered depth is a few ulps off the compiled
    reference's (its exp is XLA's, ``test_torch_depth.py``), so the scan is
    held to two 21-bit quanta and the points to 1e-5 m; validity, the
    descriptors and the GIST (which do not read the depth) as above."""
    world, fr, img, dep = _inputs(n_cams)
    pose = _rig(n_cams)
    jcfg = JCfg(node_capacity=8, edge_capacity=32, feats_per_node=FEATS, scan_bins=BINS)
    kf = jpipe.Keyframe(image=jnp.asarray(img), depth=jnp.asarray(dep),
                        odom_pose=jnp.asarray(fr["odom_pose"]), stamp=jnp.float32(fr["stamp"]))
    ref, _ = jpipe.process_keyframe(jpipe.init_state(jcfg), kf, world.cam, pose, jcfg)
    tcfg = TCfg(node_capacity=8, edge_capacity=32, feats_per_node=FEATS, scan_bins=BINS)
    assert tcfg.frontend.use_depth_refinement
    cam = tsim.WallWorld(img_h=120, img_w=160, tex_size=64).cam
    out = tpipe.keyframe_frontend(img, dep, cam, np.array(pose), tcfg, device="cpu")
    valid = np.asarray(ref.desc_valid[0])
    assert valid.sum() >= FEATS // 4
    np.testing.assert_array_equal(out.pts_valid.numpy(), valid)
    diff = np.unpackbits(out.desc.numpy() ^ np.asarray(ref.desc[0]), axis=-1)
    assert 1.0 - diff[valid].mean() >= MIN_EQUAL_BITS
    np.testing.assert_allclose(out.pts_base.numpy()[valid], np.asarray(ref.points[0])[valid],
                               rtol=0, atol=PTS_ATOL)
    ref_scan, got_scan = np.asarray(ref.scans[0]), out.scan.ranges.numpy()
    fin = np.isfinite(ref_scan)
    np.testing.assert_array_equal(np.isfinite(got_scan), fin)
    assert fin.sum() >= BINS // 12
    quantum = 1.0 / tscan.range_scale(6.0)
    np.testing.assert_allclose(got_scan[fin], ref_scan[fin], rtol=0, atol=2.5 * quantum)
    np.testing.assert_array_equal(out.gist.numpy(), np.asarray(ref.gist.desc[0]))


def test_frontend_raises_for_what_is_not_ported():
    world, fr, img, dep = _inputs(1)
    pose = np.asarray(jsim.cam_extrinsic())
    cam = tsim.WallWorld(img_h=120, img_w=160, tex_size=64).cam
    with pytest.raises(NotImplementedError, match="sift"):
        tpipe.keyframe_frontend(img, dep, cam, pose, TCfg(
            frontend=TFE(use_depth_refinement=False, descriptor="sift")), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tpipe.keyframe_frontend(np.stack([img] * 3), np.stack([dep] * 3), cam,
                                np.stack([pose] * 3), TCfg(frontend=TFE(use_depth_refinement=False)),
                                device="cpu")


def test_frontend_defaults_to_the_card():
    world, fr, img, dep = _inputs(1)
    cam = tsim.WallWorld(img_h=120, img_w=160, tex_size=64).cam
    cfg = TCfg(frontend=TFE(use_depth_refinement=False))
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.keyframe_frontend(img, dep, cam, np.asarray(jsim.cam_extrinsic()), cfg)


def test_frontend_rectifies_image_and_depth_first():
    from uzliti_slam_tpu_torch.frontend import camera as tcam

    world, fr, img, dep = _inputs(1)
    cam = tcam.PinholeCamera(130.0, 130.0, 80.0, 60.0, 160, 120, k1=-0.1, k2=0.02, p1=0.001)
    pose = tsim.cam_extrinsic(device="cpu")
    fe = dict(use_depth_refinement=False)
    cfg = TCfg(feats_per_node=FEATS, scan_bins=BINS, frontend=TFE(rectify=True, **fe))
    got = tpipe.keyframe_frontend(img, dep, cam, pose, cfg, device="cpu")
    # the same as rectifying image (bilinear) and metric depth (nearest) by hand
    img_r = tcam.rectify_image(cam, torch.from_numpy(img).float())
    dep_r = tcam.rectify_image(cam, torch.from_numpy(dep.astype(np.int32)).float() * 1e-3,
                               nearest=True)
    ref = tpipe.keyframe_frontend(img_r, dep_r, cam, pose,
                                  TCfg(feats_per_node=FEATS, scan_bins=BINS, frontend=TFE(**fe)))
    for x, y in zip(got[:5], ref[:5]):
        assert torch.equal(x, y)
    assert torch.equal(got.scan.ranges, ref.scan.ranges) and torch.equal(got.gist, ref.gist)
    assert not torch.equal(got.desc, tpipe.keyframe_frontend(
        img, dep, cam, pose, TCfg(feats_per_node=FEATS, scan_bins=BINS, frontend=TFE(**fe)),
        device="cpu").desc)
