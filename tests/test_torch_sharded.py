"""The port's edge-sharded solve (``parallel/sharded.optimize_sharded``), its
helpers and ``parallel/multihost`` against the JAX package's, on the CPU.

Worlds of 2 and 4 ranks are gloo process groups of worker processes
joined through a ``FileStore`` under ``tmp_path``, launched once for the
module; a worker imports only the port (the JAX package would pull in
the image's remote TPU backend), runs every check of its rank, saves its
arrays and prints one JSON line.  JAX's ``optimize_sharded`` runs on a 2-
and a 4-device CPU mesh in this process.  The graph is
tests/test_sharded.py's: 32 nodes, a closure every 8, the edge table
padded to a multiple of 8, 5 iterations.

Tolerances, with their reasons:
- χ²₀ and χ²₁ at ``rtol=1e-3``, as tests/test_sharded.py holds JAX's
  sharded solve against its single one: they start from the same iterate.
- the later χ² and the poses at the tightest bounds that hold
  (``LATER_CHI2_RTOL``, ``POSE_ATOL``), beside JAX's own sharded-vs-single
  gaps (``PYTHONPATH=. python tests/test_torch_sharded.py`` prints them
  all; ROADMAP C5):
  - "plain", the 32-node graph: after one iteration the solve sits in a
    flat valley (χ² 18.3 → 0.028 → 0.014) where 12 float32 PCG steps turn
    summation order into centimetres at equal χ².  JAX's own jitted
    sharded and single solves differ by 0.063 m and 1.25e-2 in χ² on 4
    devices; the port's sharded solve lands within 0.053 m and 1.1e-2 of
    JAX's sharded one.  Bounds 6e-2 m and 1.5e-2.
  - "planar", the same graph projected (χ² 11.7, no valley): the port
    within 7.2e-3 m and 2.9e-5 of JAX.  Bounds 1e-2 m and 1e-3.
  - "c1", tests/test_solver.py's 48-node graph and configuration, well
    conditioned: the port within 4.3e-5 m and 1.8e-4 of JAX (JAX's own
    gap 8.7e-6 m, 8.4e-5).  Bounds 1e-4 m and 1e-3, the single solve's.
- ranks' poses, χ² histories and edge errors: bit for bit (every rank
  takes its decisions from the same all-reduced sums).
- ``solve_fleet`` against ``optimize_batch``: bit for bit (an instance's
  sums do not depend on the fleet around it on CPU tensors).
- a world of one against ``optimize(mode="pcg")``: bit for bit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from uzliti_slam_tpu.graph import solver as jsolver
from uzliti_slam_tpu.io import synthetic as jsynthetic
from uzliti_slam_tpu.parallel import sharded as jsharded
from uzliti_slam_tpu_torch.graph import solver as tsolver
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.io import synthetic as tsynthetic
from uzliti_slam_tpu_torch.parallel import multihost, sharded

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
ITERATIONS = 5
LATER_CHI2_RTOL = {"plain": 1.5e-2, "planar": 1e-3, "c1": 1e-3}
POSE_ATOL = {"plain": 6e-2, "planar": 1e-2, "c1": 1e-4}
WORKER_TIMEOUT_S = 120
# name: (graph, configuration); "c1" is tests/test_solver.py:354-366's
# graph and configuration, well conditioned where the 32-node graph is not
CONFIGS = {"plain": ("g32", dict(iterations=ITERATIONS)),
           "planar": ("g32", dict(iterations=ITERATIONS, optimize_xy_only=True)),
           "c1": ("g48", dict(iterations=6, pcg_iterations=8, precond_refresh=3))}

WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

from uzliti_slam_tpu_torch.graph import solver, state
from uzliti_slam_tpu_torch.io import synthetic
from uzliti_slam_tpu_torch.parallel import multihost, sharded

rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
configs = json.loads(sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, f"store{world}"), world),
                        rank=rank, world_size=world)
graphs = {k: state.from_numpy(dict(np.load(os.path.join(root, f"{k}.npz"))), device="cpu")
          for k in ("g32", "g48")}
g = graphs["g32"]
out = {"rank": rank}
for name, (key, kw) in configs.items():
    cfg = solver.SolverConfig(**kw)
    sharded.reset_collectives()
    g2, hist = sharded.optimize_sharded(graphs[key], config=cfg)
    out[name] = {"collectives": sharded.collectives["all_reduce"],
                 "expected": sharded.collectives_per_solve(cfg)}
    np.savez(os.path.join(root, f"{name}_{world}_{rank}.npz"), pose=g2.pose.numpy(),
             hist=hist.numpy(), e_error=g2.e_error.numpy(), e_age=g2.e_age.numpy())
try:
    sharded.optimize_sharded(sharded.pad_edges_to_multiple(g, g.edge_capacity + 1))
    out["odd_capacity"] = "accepted"
except ValueError as e:
    out["odd_capacity"] = str(e)
mesh = multihost.pod_mesh()
out["mesh_default"] = list(mesh.mesh.shape)
g2, hist = sharded.optimize_sharded(g, group=mesh.get_group("edge"),
                                    config=solver.SolverConfig(**configs["plain"][1]))
np.savez(os.path.join(root, f"edge_group_{world}_{rank}.npz"), pose=g2.pose.numpy(),
         hist=hist.numpy())
out["mesh_batch_world"] = list(multihost.pod_mesh(batch_axis=world).mesh.shape)
out["mesh_edge_1"] = list(multihost.pod_mesh(edge_axis=1).mesh.shape)
try:
    multihost.pod_mesh(batch_axis=3, edge_axis=1)
    out["mesh_bad"] = "accepted"
except ValueError as e:
    out["mesh_bad"] = str(e)
fleet, _ = synthetic.make_pose_graph_batch(8, 24, loop_closure_every=8,
                                           generator=torch.Generator().manual_seed(1),
                                           capacity_rounding="pow2", device="cpu")
cfg = solver.SolverConfig(iterations=ITERATIONS)
got = multihost.solve_fleet(fleet, mesh, cfg)
ref = sharded.optimize_batch(fleet, cfg)
out["fleet_equal"] = {k: bool(torch.equal(getattr(got, k), getattr(ref, k)))
                      for k in ("pose", "e_error", "e_age")}
hist = solver.optimize_batched(fleet, sharded.fleet_config(cfg))[1].chi2_history
out["fleet_lowered"] = bool((hist[:, -1] < hist[:, 0]).all())
dist.destroy_process_group()
print("RESULT " + json.dumps(out), flush=True)
""".replace("ITERATIONS", str(ITERATIONS))


def _graphs():
    """tests/test_sharded.py's 32-node graph and tests/test_solver.py's
    48-node one, generated under ``jax.jit`` (eager, the generator costs
    ~10 s here), edge tables padded to a multiple of 8."""
    out = {}
    for key, seed, n in (("g32", 0, 32), ("g48", 4, 48)):
        g = jax.jit(lambda k, n=n: jsynthetic.make_pose_graph(k, n, loop_closure_every=8)[0])(
            jax.random.PRNGKey(seed))
        out[key] = jsharded.pad_edges_to_multiple(g, 8)
    return out


def _jax_sharded(g, world: int, kw: dict):
    """JAX's sharded solve on a ``world``-device CPU mesh, under ``jax.jit``
    (as tests/test_sharded.py's ``test_jit_wrapped``; eager, its
    components and write-back compile op by op, ~40 s a call here)."""
    mesh, cfg = _mesh(world), jsolver.SolverConfig(**kw)
    return jax.jit(lambda gr: jsharded.optimize_sharded(gr, mesh, "edge", cfg))(g)


def _arrays(g):
    return {k: np.asarray(v) for k, v in g._asdict().items()}


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("edge",))


@pytest.fixture(scope="module")
def graphs():
    return _graphs()


@pytest.fixture(scope="module")
def graph(graphs):
    return graphs["g32"]


def start_worlds(graphs, root: Path) -> dict:
    """Both worlds' ranks started at once: {(world, rank): process}."""
    for key, g in graphs.items():
        np.savez(root / f"{key}.npz", **_arrays(g))
    (root / "worker.py").write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT), LOCAL_WORLD_SIZE="2")
    return {(w, r): subprocess.Popen(
        [sys.executable, str(root / "worker.py"), str(r), str(w), str(root), json.dumps(CONFIGS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for w in WORLDS for r in range(w)}


def collect_worlds(procs: dict, root: Path) -> dict:
    """{world: [(rank's JSON, {config: rank's arrays})]}, each rank waited
    for at most ``WORKER_TIMEOUT_S``; every process is gone after it."""
    outs = {}
    try:
        for key, p in procs.items():
            outs[key] = p.communicate(timeout=WORKER_TIMEOUT_S)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = {w: [] for w in WORLDS}
    for (w, r), (out, err) in outs.items():
        assert procs[(w, r)].returncode == 0, err[-3000:]
        line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
        arrays = {name: dict(np.load(root / f"{name}_{w}_{r}.npz"))
                  for name in (*CONFIGS, "edge_group")}
        results[w].append((json.loads(line[len("RESULT "):]), arrays))
    return results


def jax_solves(graphs) -> dict:
    """JAX's sharded solves: {(config, world): (poses, χ² history)}."""
    out = {}
    for name, (key, kw) in CONFIGS.items():
        for w in WORLDS:
            g2, hist = _jax_sharded(graphs[key], w, kw)
            out[(name, w)] = (np.asarray(g2.pose), np.asarray(hist))
    return out


@pytest.fixture(scope="module")
def both(graphs, tmp_path_factory):
    """The worlds' results and JAX's, JAX compiling while the ranks run."""
    root = tmp_path_factory.mktemp("sharded")
    procs = start_worlds(graphs, root)
    try:
        ref = jax_solves(graphs)
    finally:
        ranks = collect_worlds(procs, root)
    return ranks, ref


@pytest.fixture(scope="module")
def worlds(both):
    return both[0]


@pytest.fixture(scope="module")
def jax_sharded(both):
    return both[1]


def _hist_close(got, ref, later_rtol):
    np.testing.assert_allclose(got[:2], ref[:2], rtol=1e-3)
    np.testing.assert_allclose(got, ref, rtol=later_rtol)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_solve_matches_jax(worlds, jax_sharded, name, world):
    arrays = worlds[world][0][1][name]
    pose_j, hist_j = jax_sharded[(name, world)]
    _hist_close(arrays["hist"], hist_j, LATER_CHI2_RTOL[name])
    assert hist_j[-1] < 0.7 * hist_j[0]
    np.testing.assert_allclose(arrays["pose"], pose_j, atol=POSE_ATOL[name])


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_end_bit_identical(worlds, world):
    ranks = worlds[world]
    assert [res["rank"] for res, _ in ranks] == list(range(world))
    for name in CONFIGS:
        first = ranks[0][1][name]
        for _, arrays in ranks[1:]:
            for key in ("pose", "hist", "e_error", "e_age"):
                np.testing.assert_array_equal(arrays[name][key], first[key],
                                              err_msg=f"{name} {key}")


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_counted(worlds, world):
    for res, _ in worlds[world]:
        for name, (_, kw) in CONFIGS.items():
            cfg = tsolver.SolverConfig(**kw)
            chunks = -(-cfg.iterations // cfg.precond_refresh)
            assert res[name]["collectives"] == res[name]["expected"]
            assert res[name]["expected"] == 1 + chunks + cfg.iterations * (cfg.pcg_iterations + 2)
        assert "not divisible" in res["odd_capacity"]


@pytest.mark.parametrize("world", WORLDS)
def test_pod_mesh(worlds, world):
    # LOCAL_WORLD_SIZE=2: one host of 2 ranks, or two hosts of 2
    for res, _ in worlds[world]:
        assert res["mesh_default"] == [world // 2, 2]
        assert res["mesh_batch_world"] == [world, 1]
        assert res["mesh_edge_1"] == [world, 1]
        assert "devices" in res["mesh_bad"]


def test_a_pod_meshs_edge_group_solves_as_a_world_of_its_size(worlds):
    """Under LOCAL_WORLD_SIZE=2 the 4-rank world's pod mesh is 2 x 2: each
    "edge" row is a group of 2 ranks, whose sharded solve equals the
    2-rank world's bit for bit (the same shards summed in the same order);
    the 2-rank world's mesh is 1 x 2, its edge group the world."""
    ref = worlds[2][0][1]["plain"]
    for world in WORLDS:
        for _, arrays in worlds[world]:
            got = arrays["edge_group"]
            np.testing.assert_array_equal(got["pose"], ref["pose"])
            np.testing.assert_array_equal(got["hist"], ref["hist"])


@pytest.mark.parametrize("world", WORLDS)
def test_solve_fleet_equals_optimize_batch(worlds, world):
    for res, _ in worlds[world]:
        assert res["fleet_equal"] == {"pose": True, "e_error": True, "e_age": True}
        assert res["fleet_lowered"]


def test_pad_and_shard_edges_match_jax(graph):
    g, _ = jsynthetic.make_pose_graph(jax.random.PRNGKey(0), 10)
    gt = tstate.from_numpy(_arrays(g), device="cpu")
    for multiple in (3, 8):
        ref = jsharded.pad_edges_to_multiple(g, multiple)
        got = sharded.pad_edges_to_multiple(gt, multiple)
        assert got.edge_capacity % multiple == 0
        for k, v in _arrays(ref).items():
            np.testing.assert_array_equal(getattr(got, k).numpy(), v, err_msg=k)
    # contiguous blocks over the edge fields, the node fields whole: what
    # P("edge") gives each device of JAX's mesh
    full = tstate.from_numpy(_arrays(graph), device="cpu")
    specs = jsharded.graph_partition_specs("edge")
    for world in WORLDS:
        blocks = [sharded.shard_edges(full, r, world) for r in range(world)]
        for k in tstate._FIELDS:
            parts = [getattr(b, k) for b in blocks]
            if getattr(specs, k) == jax.sharding.PartitionSpec("edge"):
                assert all(p.shape[0] == full.edge_capacity // world for p in parts), k
                assert torch.equal(torch.cat(parts), getattr(full, k)), k
            else:
                assert all(p is getattr(full, k) for p in parts), k
    with pytest.raises(ValueError, match="not divisible"):
        sharded.shard_edges(sharded.pad_edges_to_multiple(full, 3), 0, 8)


@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_world_of_one_is_the_generic_loop(graph, world_of_one):
    # early exit asked for: the sharded and the generic loops ignore it
    gt = tstate.from_numpy(_arrays(graph), device="cpu")
    cfg = tsolver.SolverConfig(iterations=ITERATIONS, early_exit=True)
    sharded.reset_collectives()
    g1, hist = sharded.optimize_sharded(gt, config=cfg)
    assert sharded.collectives["all_reduce"] == sharded.collectives_per_solve(cfg)
    g2, st = tsolver.optimize(gt, tsolver.SolverConfig(iterations=ITERATIONS, mode="pcg"))
    assert torch.equal(hist, st.chi2_history)
    for k in ("pose", "e_error", "e_age"):
        assert torch.equal(getattr(g1, k), getattr(g2, k)), k
    fleet, _ = tsynthetic.make_pose_graph_batch(2, 24, generator=torch.Generator().manual_seed(2),
                                                capacity_rounding="pow2", device="cpu")
    got = multihost.solve_fleet(fleet, config=cfg)
    assert torch.equal(got.pose, sharded.optimize_batch(fleet, cfg).pose)


def test_without_a_process_group_it_raises(graph):
    assert not dist.is_initialized()
    gt = tstate.from_numpy(_arrays(graph), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        sharded.optimize_sharded(gt)
    with pytest.raises(RuntimeError, match="process group"):
        multihost.pod_mesh()
    assert multihost.initialize() is None and not dist.is_initialized()
    with pytest.raises(ValueError, match="together"):
        multihost.initialize(coordinator="localhost:1")


def gaps(root: Path) -> dict:
    """Largest gaps after the solve, per configuration and world: the port's
    sharded solve against JAX's, and JAX's sharded against JAX's single
    solve (poses, and χ² past the first two entries, relative)."""
    gs = _graphs()
    ranks = collect_worlds(start_worlds(gs, root), root)
    out = {}
    for name, (key, kw) in CONFIGS.items():
        g_s, st_s = jsolver.optimize(gs[key], jsolver.SolverConfig(**kw))
        single, hist_s = np.asarray(g_s.pose), np.asarray(st_s.chi2_history)
        for w in WORLDS:
            g_j, hist_j = _jax_sharded(gs[key], w, kw)
            pose_j, hist_j = np.asarray(g_j.pose), np.asarray(hist_j)
            pose_t, hist_t = ranks[w][0][1][name]["pose"], ranks[w][0][1][name]["hist"]
            out[f"{name} {w} ranks: port vs jax sharded"] = (
                float(np.abs(pose_t - pose_j).max()),
                float(np.max(np.abs(hist_t - hist_j)[2:] / hist_j[2:])))
            if kw.get("optimize_xy_only"):
                continue      # the single solve flattens its start, the sharded one does not
            out[f"{name} {w} ranks: jax sharded vs jax single"] = (
                float(np.abs(pose_j - single).max()),
                float(np.max(np.abs(hist_j - hist_s)[2:] / hist_s[2:])))
    return out


if __name__ == "__main__":
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    jsynthetic.capacity_rounding = "pow2"    # as tests/conftest.py sets it
    with tempfile.TemporaryDirectory() as tmp:
        for k, (pose, chi2) in gaps(Path(tmp)).items():
            print(f"{k}: poses {pose:.3g}, later χ² {chi2:.3g}")
