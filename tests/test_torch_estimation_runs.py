"""tests/test_estimation_methods.py's runs through the port's ``Slam`` on
the CPU: the "pnp" and "gicp" estimators over the 24-frame 96x128
WallWorld drive with that test's configuration, held to its bars (>= 3
loop closures proposed and >= 1 validated, ATE no worse than the
odometry's; for "pnp" ATE < 0.2 m; for "gicp" >= 10 nodes with a cloud).
The draws are the port's own (``ROADMAP.md`` C2): these are the
reference's end-to-end bars, not a step-by-step comparison, which is
``tests/test_torch_estimation.py``.
"""

import numpy as np
import pytest
import torch

from uzliti_slam_tpu_torch import pipeline as tpipe
from uzliti_slam_tpu_torch.config import EdgeEstimationConfig as TEst
from uzliti_slam_tpu_torch.config import KeyframeConfig as TKf
from uzliti_slam_tpu_torch.config import SlamConfig as TCfg
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.io import simulator as tsim
from uzliti_slam_tpu_torch.io import synthetic as tsyn


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_method(method: str, **est_kw):
    """tests/test_estimation_methods.py's run_method through the port's Slam."""
    cfg = TCfg(node_capacity=64, edge_capacity=256, feats_per_node=96, scan_bins=180,
               keyframe=TKf(new_node_distance=0.25),
               estimation=TEst(method=method, min_consensus=10, min_matching_score=8.0,
                               **est_kw))
    world = tsim.WallWorld(img_h=96, img_w=128)
    frames = tsim.simulate_sequence(world, n_frames=24, odom_drift=0.08, length=5.0)
    slam = tpipe.Slam(cfg, cam=world.cam, cam_pose=tsim.cam_extrinsic(device="cpu"),
                      device="cpu")
    slam.optimize_every = 12
    for fr in frames:
        slam.add_frame(fr["image"], fr["depth"], fr["odom_pose"], fr["stamp"])
    slam.optimize()
    g = slam.state.graph
    n, ne = int(g.num_nodes), int(g.num_edges)
    stamps = g.stamp[:n].numpy().astype(int)
    gt = torch.from_numpy(np.stack([frames[s]["gt_pose"] for s in stamps]))
    odo = torch.from_numpy(np.stack([frames[s]["odom_pose"] for s in stamps]))
    ate, ate_odo = float(tsyn.ate_rmse(g.pose[:n], gt)), float(tsyn.ate_rmse(odo, gt))
    lc = g.e_type[:ne].numpy() == tstate.EDGE_TYPE_3D_FULL
    ev = g.e_valid[:ne].numpy()
    return slam, ate, ate_odo, int(lc.sum()), int(ev[lc].sum())


def test_pnp_method_meets_the_reference_bars():
    slam, ate, ate_odo, n_lc, n_val = run_method("pnp")
    assert n_lc >= 3 and n_val >= 1, (n_lc, n_val)
    assert ate <= ate_odo + 1e-6 and ate < 0.2, (ate, ate_odo)


def test_gicp_method_meets_the_reference_bars():
    slam, ate, ate_odo, n_lc, n_val = run_method("gicp", gicp_max_voxels=192)
    assert slam.state.clouds is not None
    assert int(slam.state.cloud_valid.any(-1).sum()) >= 10
    assert n_lc >= 3 and n_val >= 1, (n_lc, n_val)
    assert ate <= ate_odo + 1e-6, (ate, ate_odo)
