"""The port's scope protocol across a process boundary, and its demo.

tests/test_scope_transport.py on the port: the GLOBAL role runs in a child
process that imports only the port (a worker script written to
``tmp_path``; the JAX package's site setup would pull its remote backend
into a spawned interpreter).  ``GraphDelta`` / ``Ack`` / ``ScopeReply``
cross as length-prefixed pickles of numpy dicts (``scope.to_numpy``, and
``*_from_numpy`` on the receiving side) over stdin/stdout, and the child
runs the same ``runner.global_exchange_step`` as the in-process runner.
The remote global trajectory must match an in-process ``LocalGlobalSlam``
run on the same frames, node by node (within 1e-3, the reference test's
bound; both sides draw from generators of the same seed on the CPU).
Then ``demo.main_local_global`` on the CPU, with its PASS.
"""

import os
import pickle
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from uzliti_slam_tpu_torch import demo, runner
from uzliti_slam_tpu_torch.config import EdgeEstimationConfig, KeyframeConfig, ScopeConfig
from uzliti_slam_tpu_torch.config import SlamConfig
from uzliti_slam_tpu_torch.io import simulator
from uzliti_slam_tpu_torch.parallel import scope

WORKER = r"""
import pickle, struct, sys
import numpy as np
import torch

torch.set_num_threads(1)
from uzliti_slam_tpu_torch import pipeline, runner
from uzliti_slam_tpu_torch.frontend import camera
from uzliti_slam_tpu_torch.parallel import scope

inp, out = sys.stdin.buffer, sys.stdout.buffer

def recv():
    hdr = inp.read(8)
    if len(hdr) < 8:
        return None
    (n,) = struct.unpack("<Q", hdr)
    return pickle.loads(inp.read(n))

def send(obj):
    blob = pickle.dumps(obj)
    out.write(struct.pack("<Q", len(blob)))
    out.write(blob)
    out.flush()

msg = recv()
assert msg["type"] == "init"
gslam = pipeline.Slam(msg["config"], cam=camera.PinholeCamera(**msg["cam"]),
                      cam_pose=msg["cam_pose"], device="cpu")
send({"ok": True})
while True:
    msg = recv()
    if msg is None or msg["type"] == "finish":
        g = gslam.state.graph
        n = int(g.num_nodes)
        valid = g.node_valid[:n].numpy()
        send({"poses": g.pose[:n].numpy()[valid], "uids": g.node_uid[:n].numpy()[valid],
              "odom_params": g.odom_params.numpy()})
        break
    ack, reply, info = runner.global_exchange_step(
        gslam, scope.delta_from_numpy(msg["delta"], "cpu"), msg["robot"], msg["radius"],
        msg["delta_nodes"], msg["delta_edges"])
    send({"ack": scope.to_numpy(ack), "reply": scope.to_numpy(reply),
          "info": {k: v for k, v in info.items() if k != "tri"}})
"""


def _send(proc, obj):
    blob = pickle.dumps(obj)
    proc.stdin.write(struct.pack("<Q", len(blob)))
    proc.stdin.write(blob)
    proc.stdin.flush()


def _recv(proc):
    hdr = proc.stdout.read(8)
    assert len(hdr) == 8, "worker died: " + proc.stderr.read().decode()[-3000:]
    (n,) = struct.unpack("<Q", hdr)
    return pickle.loads(proc.stdout.read(n))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_scope_protocol_across_process_boundary(tmp_path):
    cfg = SlamConfig(
        node_capacity=64, edge_capacity=256, feats_per_node=64, scan_bins=90,
        keyframe=KeyframeConfig(new_node_distance=0.25),
        estimation=EdgeEstimationConfig(min_consensus=8, min_matching_score=6.0),
        scope=ScopeConfig(scope_size_min=2.0, eviction_margin=0.5))
    world = simulator.WallWorld(img_h=96, img_w=128)
    frames = simulator.simulate_sequence(world, n_frames=18, odom_drift=0.05, length=5.0)
    cam_pose = simulator.cam_extrinsic(device="cpu")

    ref = runner.LocalGlobalSlam(cfg, cam=world.cam, cam_pose=cam_pose, device="cpu")
    ref.local.optimize_every = 10 ** 9
    for i, fr in enumerate(frames):
        ref.add_frame(fr["image"], fr["depth"], fr["odom_pose"], fr["stamp"])
        if (i + 1) % 6 == 0:
            ref.exchange()
    ref.exchange()
    ref_poses, ref_uids, _ = ref.global_trajectory()

    wfile = tmp_path / "global_worker.py"
    wfile.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.Popen([sys.executable, str(wfile)], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
    try:
        duo = runner.LocalGlobalSlam(cfg, cam=world.cam, cam_pose=cam_pose, device="cpu")
        duo.local.optimize_every = 10 ** 9
        cam = world.cam
        _send(proc, {"type": "init", "config": duo.global_slam.config,
                     "cam": {k: getattr(cam, k) for k in cam._fields},
                     "cam_pose": cam_pose.numpy()})
        assert _recv(proc)["ok"]

        def exchange_over_pipe():
            delta, robot, radius = duo.local_make_request()
            _send(proc, {"type": "exchange", "delta": scope.to_numpy(delta),
                         "robot": robot.numpy(), "radius": radius.numpy(),
                         "delta_nodes": duo.delta_nodes, "delta_edges": duo.delta_edges})
            resp = _recv(proc)
            duo.local_apply_response(scope.ack_from_numpy(resp["ack"], "cpu"),
                                     scope.reply_from_numpy(resp["reply"], "cpu"))

        for i, fr in enumerate(frames):
            duo.add_frame(fr["image"], fr["depth"], fr["odom_pose"], fr["stamp"])
            if (i + 1) % 6 == 0:
                exchange_over_pipe()
        exchange_over_pipe()
        _send(proc, {"type": "finish"})
        final = _recv(proc)
    finally:
        proc.kill()
        proc.wait()

    kf_uids = final["uids"][final["uids"] < 1_000_000]
    assert len(kf_uids) == duo.local._n_kf_host
    ref_by_uid = {int(u): ref_poses[i] for i, u in enumerate(ref_uids)}
    matched = 0
    for i, u in enumerate(final["uids"]):
        if int(u) in ref_by_uid:
            np.testing.assert_allclose(final["poses"][i], ref_by_uid[int(u)], atol=1e-3)
            matched += 1
    assert matched == len(ref_uids) == len(final["uids"])
    np.testing.assert_array_equal(final["odom_params"],
                                  ref.global_slam.state.graph.odom_params.numpy())


def test_demo_local_global_passes_on_cpu(capsys):
    rc = demo.main(["--roles", "local,global", "--device", "cpu", "--frames", "24"])
    out = capsys.readouterr().out
    assert "== RESULT: PASS" in out and rc == 0
    assert "global ATE" in out and "keyframes" in out
