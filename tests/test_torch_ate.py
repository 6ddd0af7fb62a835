"""The end-to-end ATE rung (``chip_smoke.py`` phase 12) on the CPU.

The JAX bench's ``bench_ate`` (48 frames at 96x128, 64 features, 90 bins,
keyframe gate 0.2 m, an epoch every 8 keyframes and a final one) through
the port's ``Slam``: its ATE below the raw odometry's and within the bar
that phase 12 holds the card to (``chip_smoke.ATE_BAR_M``).

Run as a script, it prints the readings the bar is derived from: the rung
through the JAX package and through the port, on the CPU, for each seed of
the RANSAC draws given::

    PYTHONPATH=. python tests/test_torch_ate.py 0 1 2 3 4 5 6 7
"""

import sys

import numpy as np
import pytest
import torch

from chip_smoke import ATE_BAR_M, ATE_RUN, ate_run


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_ate_rung_beats_odometry_within_the_bar():
    r = ate_run("cpu", seed=0)
    assert r["keyframes"] >= 40 and r["valid_loop_closures"] >= 3
    assert r["ate_slam_m"] < r["ate_odometry_m"]
    assert r["ate_slam_m"] <= ATE_BAR_M


def jax_ate(seed: int) -> tuple[float, float]:
    """``bench.bench_ate`` of the JAX package, with the RANSAC key made
    from ``seed``: (ATE of SLAM, ATE of the raw odometry), metres."""
    import jax.numpy as jnp

    from uzliti_slam_tpu import pipeline
    from uzliti_slam_tpu.config import EdgeEstimationConfig, KeyframeConfig, SlamConfig
    from uzliti_slam_tpu.io import simulator, synthetic

    a = ATE_RUN
    cfg = SlamConfig(node_capacity=a["node_capacity"], edge_capacity=a["edge_capacity"],
                     feats_per_node=a["feats"], scan_bins=a["scan_bins"],
                     keyframe=KeyframeConfig(new_node_distance=a["gate"]),
                     estimation=EdgeEstimationConfig(min_consensus=8, min_matching_score=6.0))
    world = simulator.WallWorld(img_h=a["img_h"], img_w=a["img_w"])
    frames = simulator.simulate_sequence(world, n_frames=a["n_frames"], odom_drift=a["odom_drift"],
                                         length=a["length"])
    slam = pipeline.Slam(cfg, cam=world.cam, cam_pose=simulator.cam_extrinsic(), seed=seed)
    slam.optimize_every = a["optimize_every"]
    for fr in frames:
        slam.add_frame(np.asarray(fr["image"]), np.asarray(fr["depth"]),
                       np.asarray(fr["odom_pose"]), float(fr["stamp"]))
    slam.optimize()
    poses, valid = slam.trajectory()
    v = np.asarray(valid)
    stamps = np.asarray(slam.state.graph.stamp[: v.shape[0]])[v].astype(int)
    gt = jnp.stack([frames[s]["gt_pose"] for s in stamps])
    odom = jnp.stack([frames[s]["odom_pose"] for s in stamps])
    return (float(synthetic.ate_rmse(jnp.asarray(np.asarray(poses)[v]), gt)),
            float(synthetic.ate_rmse(odom, gt)))


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    for seed in [int(s) for s in sys.argv[1:]] or [0]:
        slam_j, odom_j = jax_ate(seed)
        r = ate_run("cpu", seed)
        print(f"seed {seed}: jax {slam_j!r} port {r['ate_slam_m']!r} "
              f"odometry {odom_j!r} / {r['ate_odometry_m']!r}", flush=True)
