"""End-to-end demo: a simulated RGB-D sequence through the port's SLAM.

Usage:  python -m uzliti_slam_tpu_torch.demo [--frames N] [--drift D]
            [--roles single|local,global] [--device cpu]

PyTorch counterpart of ``uzliti_slam_tpu/demo.py``.  It runs on the CUDA
card unless given ``--device cpu``, and prints per-keyframe (or
per-exchange) progress, the final ATE against ground truth and odometry
and a ``RESULT`` line: the equivalent of replaying the reference's dataset
launch and reading the overlay.  ``--roles local,global`` runs the
reference's two-instance topology (``runner.LocalGlobalSlam``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--drift", type=float, default=0.08)
    ap.add_argument("--length", type=float, default=5.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    ap.add_argument("--roles", default="single",
                    help="'single' (one instance) or 'local,global' (two wired instances)")
    return ap.parse_args(argv)


def _base_config(**scope):
    from uzliti_slam_tpu_torch.config import (EdgeEstimationConfig, KeyframeConfig, ScopeConfig,
                                              SlamConfig)
    return SlamConfig(
        node_capacity=64, edge_capacity=256, feats_per_node=96, scan_bins=180,
        keyframe=KeyframeConfig(new_node_distance=0.25),
        estimation=EdgeEstimationConfig(min_consensus=10, min_matching_score=8.0),
        **({"scope": ScopeConfig(**scope)} if scope else {}))


def _gt(frames, stamps, key: str) -> torch.Tensor:
    return torch.from_numpy(np.stack([np.asarray(frames[int(s)][key]) for s in stamps]))


def main(argv=None) -> int:
    args = _args(argv)
    if args.roles == "local,global":
        return main_local_global(args)
    from uzliti_slam_tpu_torch import _device, pipeline
    from uzliti_slam_tpu_torch.graph import state as gstate
    from uzliti_slam_tpu_torch.io import simulator, synthetic

    dev = _device.resolve(args.device)
    cfg = _base_config()
    world = simulator.WallWorld(img_h=96, img_w=128)
    frames = simulator.simulate_sequence(world, n_frames=args.frames, odom_drift=args.drift,
                                         length=args.length)
    slam = pipeline.Slam(cfg, cam=world.cam, cam_pose=simulator.cam_extrinsic(device=dev),
                         device=dev)
    slam.optimize_every = 12

    t0 = time.perf_counter()
    n_kf = 0
    for i, fr in enumerate(frames):
        info = slam.add_frame(fr["image"], fr["depth"], fr["odom_pose"], fr["stamp"])
        if info:
            n_kf += 1
            print(f"frame {i:3d}: keyframe #{n_kf} features={int(info['n_features'])} "
                  f"closure-candidates={int(info['n_candidates'])} "
                  f"edges={int(info['n_edges_proposed'])}")
    stats = slam.optimize()
    dt = time.perf_counter() - t0

    g = slam.state.graph
    n = int(g.num_nodes)
    stamps = g.stamp[:n].cpu().numpy().astype(int)
    ate = float(synthetic.ate_rmse(g.pose[:n].cpu(), _gt(frames, stamps, "gt_pose")))
    ate_odo = float(synthetic.ate_rmse(_gt(frames, stamps, "odom_pose"),
                                       _gt(frames, stamps, "gt_pose")))
    ne = int(g.num_edges)
    et = g.e_type[:ne].cpu().numpy()
    ev = g.e_valid[:ne].cpu().numpy()
    lc = et == gstate.EDGE_TYPE_3D_FULL
    print(f"\n== {n} keyframes, {ne} edges "
          f"({(et == gstate.EDGE_TYPE_2D_WHEEL_ODOMETRY).sum()} odom, "
          f"{(et == gstate.EDGE_TYPE_2D_LASER).sum()} laser, "
          f"{lc.sum()} visual closures, {ev[lc].sum()} validated)")
    tern = slam.map_ternary().cpu().numpy()
    print(f"== map {tern.shape[0]}x{tern.shape[1]} @ {cfg.grid.resolution} m: "
          f"{(tern == 100).sum()} occupied, {(tern == 0).sum()} free, "
          f"{(tern == -1).sum()} unknown cells")
    print(f"== chi2 {float(stats.chi2_history[0]):.3f} -> {float(stats.chi2_history[-1]):.3f}")
    print(f"== ATE slam {ate:.4f} m  vs odometry {ate_odo:.4f} m  ({dt:.1f}s wall, {dev})")
    ok = ate < 0.2 and ate < ate_odo
    print("== RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def main_local_global(args) -> int:
    """Two live SLAM instances and the scope protocol end to end: the local
    ingests and stays bounded, the global accumulates, merges and
    optimizes; the exchange runs every 6 frames (the reference's scope
    timer), then 8 rounds drain the resend queue."""
    from uzliti_slam_tpu_torch import _device, runner
    from uzliti_slam_tpu_torch.io import simulator, synthetic

    dev = _device.resolve(args.device)
    cfg = _base_config(scope_size_min=3.0, eviction_margin=1.0)
    world = simulator.WallWorld(img_h=96, img_w=128)
    frames = simulator.simulate_sequence(world, n_frames=args.frames, odom_drift=args.drift,
                                         length=args.length)
    duo = runner.LocalGlobalSlam(cfg, cam=world.cam,
                                 cam_pose=simulator.cam_extrinsic(device=dev), device=dev)
    duo.local.optimize_every = 12

    t0 = time.perf_counter()
    for i, fr in enumerate(frames):
        duo.add_frame(fr["image"], fr["depth"], fr["odom_pose"], fr["stamp"])
        if (i + 1) % 6 == 0:
            ex = duo.exchange()
            print(f"frame {i:3d}: exchange acked={ex['acked_nodes']} "
                  f"evicted_local={ex['evicted_local']} merged_global={ex['merged_global']} "
                  f"proposed_global={ex['proposed_global']}")
    for _ in range(8):          # drain the resend queue
        duo.exchange()
    dt = time.perf_counter() - t0

    poses, uids, stamps = duo.global_trajectory()
    keyframe_rows = uids < 1_000_000        # instance 0: the local's keyframes
    stamps_kf = stamps[keyframe_rows].astype(int)
    ate = float(synthetic.ate_rmse(torch.from_numpy(poses[keyframe_rows]),
                                   _gt(frames, stamps_kf, "gt_pose")))
    n_local = int(duo.local.state.graph.node_valid.sum())
    print(f"\n== global map: {len(poses)} nodes ({keyframe_rows.sum()} keyframes); "
          f"local window: {n_local} live nodes")
    tern = duo.global_slam.map_ternary().cpu().numpy()
    print(f"== global occupancy {tern.shape[0]}x{tern.shape[1]}: "
          f"{(tern == 100).sum()} occupied, {(tern == 0).sum()} free")
    print(f"== global ATE {ate:.4f} m  ({dt:.1f}s wall, {dev})")
    ok = ate < 0.25 and n_local < len(poses)
    print("== RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
