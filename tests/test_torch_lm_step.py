"""K36 (``kernels/ops.lm_candidate`` / ``lm_accept``): the LM iteration's
tail, against the JAX package on the CPU.

The candidate's plain version against JAX's ``lie.pose_retract``,
``factors.batched_residuals`` and ``solver._robust_chi2_from_r`` under
``jax.jit`` on a 200-node graph with a seeded step, a fleet of three and
the planar mask: poses within 1e-6, residuals within 1e-5, χ² within 1e-6
relative.  The accept rule's plain version, both loop forms, against a
float32 replay of the reference's rules (``solver.py:925-946`` with the
early exit, ``:988-997`` without) over seeded χ² sequences that drive λ
to both clamps and end the early exit at λ_max: bit for bit.  The loop's
launches on meta tensors are in tests/test_torch_kernels.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.graph import factors as jfactors
from uzliti_slam_tpu.graph import solver as jsolver
from uzliti_slam_tpu.ops import lie as jlie
from uzliti_slam_tpu_torch.graph import solver as tsolver
from uzliti_slam_tpu_torch.io import synthetic as tsynthetic
from uzliti_slam_tpu_torch.kernels import ops as kops

POSE_ATOL, R_ATOL, CHI2_RTOL = 1e-6, 1e-5, 1e-6


def _graph(n=200, batch=None, seed=3):
    gen = torch.Generator().manual_seed(seed)
    if batch is None:
        g, _ = tsynthetic.make_pose_graph(n, loop_closure_every=10, generator=gen, device="cpu")
        return g, 1
    fleet, _ = tsynthetic.make_pose_graph_batch(batch, n, loop_closure_every=8, generator=gen,
                                               device="cpu")
    return tsolver._flatten_fleet(fleet), batch


def _free(g, batch):
    n = g.node_capacity // batch
    labels = tsolver.connected_components(g, tsolver.component_iterations(n))
    return (g.node_valid & ~tsolver.gauge_fix_mask(g, labels)).float()


@jax.jit
def _jax_candidate(poses, dx, e_from, e_to, meas):
    cand = jlie.pose_retract(poses, dx)
    return cand, jfactors.batched_residuals(cand[e_from], cand[e_to], meas)


@jax.jit
def _jax_chi2(r, info, valid):
    return jsolver._robust_chi2_from_r(types.SimpleNamespace(e_info=info, e_valid=valid), r, 1.0)


@pytest.mark.parametrize("case", ["single", "fleet", "planar"])
def test_candidate_plain_matches_jax(case):
    g, B = _graph(64, batch=3) if case == "fleet" else _graph()
    if case == "planar":
        g = g.replace(pose=tsolver.flatten_planar(g.pose, g.node_valid))
    free = _free(g, B)
    rng = np.random.default_rng(11)
    dx = torch.from_numpy(0.05 * rng.normal(size=(g.node_capacity, 6)).astype(np.float32))
    if case == "planar":
        dx = dx * tsolver._xy_mask(torch.float32, "cpu")
    valid = g.e_valid.float()
    cand, r, chi2 = kops.lm_candidate_plain(g.pose, dx, free, g.e_from, g.e_to, g.e_transform,
                                            g.e_info, valid, 1.0, B)
    # the wrapper on CPU tensors is the plain version
    for a, b in zip(kops.lm_candidate(g.pose, dx, free, g.e_from, g.e_to, g.e_transform,
                                      g.e_info, valid, 1.0, B), (cand, r, chi2)):
        assert torch.equal(a, b)
    j = {k: jnp.asarray(v.numpy()) for k, v in dict(pose=g.pose, dx=dx * free[:, None],
                                                     ef=g.e_from, et=g.e_to, m=g.e_transform,
                                                     info=g.e_info, valid=valid).items()}
    cand_j, r_j = _jax_candidate(j["pose"], j["dx"], j["ef"], j["et"], j["m"])
    np.testing.assert_allclose(cand.numpy(), np.asarray(cand_j), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_j), rtol=0, atol=R_ATOL)
    E = g.e_from.shape[0] // B
    chi2_j = [float(_jax_chi2(r_j[b * E:(b + 1) * E], j["info"][b * E:(b + 1) * E],
                              j["valid"][b * E:(b + 1) * E])) for b in range(B)]
    assert chi2.shape == (B,)
    np.testing.assert_allclose(chi2.numpy(), chi2_j, rtol=CHI2_RTOL)
    # fixed nodes keep their poses; the planar step keeps z, roll and pitch
    fixed = free == 0
    assert fixed.any()
    torch.testing.assert_close(cand[fixed], g.pose[fixed], rtol=0, atol=POSE_ATOL)
    if case == "planar":
        flat = tsolver.flatten_planar(cand, g.node_valid)
        torch.testing.assert_close(flat, cand, rtol=0, atol=1e-6)


def _replay(chi2_0, seq, rules, iterations):
    """The reference's accept rules in float32 (solver.py:925-946 with the
    early exit, :988-997 without), one instance: (history, λ after each
    iteration, accept flags, the iterations at which the early exit's loop
    builds a factor)."""
    f32 = np.float32
    lam, stale, done, cur = f32(rules.lam_init), 0, False, f32(chi2_0)
    hist, lams, acc, builds = [cur], [lam], [], []
    for it in range(iterations):
        if rules.early_exit and not done and (it == 0 or stale >= rules.refresh):
            builds.append(it)
            stale = 0
        new = f32(seq[it])
        accept = bool(new < cur) and not done
        if rules.early_exit and not done:
            gain = (cur - new) / max(cur, f32(1e-12))
            finished = ((accept and gain < f32(rules.tol) and lam <= f32(rules.lam_init))
                        or (not accept and lam >= f32(rules.lam_max)))
        nxt = f32(np.clip(lam / f32(rules.factor) if accept else lam * f32(rules.factor),
                          f32(rules.lam_min), f32(rules.lam_max)))
        if not done:
            lam = nxt
        if rules.early_exit:
            stale = stale + 1 if accept else rules.refresh
            done = done or finished
        cur = new if accept else cur
        hist.append(cur)
        lams.append(lam)
        acc.append(accept)
    return hist, lams, acc, builds


def _sequences(chi2_0, iterations):
    """Per instance a χ² sequence: rejects up to λ_max (and the early exit's
    stop there), accepts down to λ_min with tiny gains, and seeded draws."""
    rng = np.random.default_rng(5)
    stuck = [chi2_0 * 2.0] * iterations
    down = [chi2_0 * (1.0 - 1e-8 * (k + 1)) for k in range(iterations)]
    mixed = list(chi2_0 * rng.uniform(0.2, 1.6, iterations))
    ramp = [chi2_0 * 0.9 ** (k + 1) if k % 4 != 3 else chi2_0 * 3.0 for k in range(iterations)]
    return [stuck, down, mixed, ramp]


@pytest.mark.parametrize("early_exit", [False, True], ids=["fixed", "early_exit"])
def test_accept_plain_follows_the_reference_rules(early_exit):
    iterations, B = 20, 4
    rules = kops.LmRules(3.0, 1e-6, 1e-2, 1e-4, 1e-6, 5, early_exit)
    chi2_0 = np.float32(1234.5)
    seqs = _sequences(float(chi2_0), iterations)
    n, E = 3, 4
    poses0 = torch.arange(B * n * 7, dtype=torch.float32).view(B * n, 7)
    r0 = torch.zeros(B * E, 6)
    s = kops.lm_state(poses0, r0, torch.full((B,), float(chi2_0)), iterations, rules.lam_init, B)
    for it in range(iterations):
        cand = poses0 + (it + 1)
        r_cand = torch.full((B * E, 6), float(it + 1))
        chi2_new = torch.tensor([seq[it] for seq in seqs], dtype=torch.float32)
        kops.lm_accept(s, cand, r_cand, chi2_new, it, rules)   # CPU: the plain version
    stuck_at_max = False
    for b, seq in enumerate(seqs):
        hist, lams, acc, builds = _replay(chi2_0, seq, rules, iterations)
        np.testing.assert_array_equal(s.hist[b].numpy(), np.array(hist, np.float32))
        np.testing.assert_array_equal(s.lam[b].numpy(), np.array(lams, np.float32))
        np.testing.assert_array_equal(s.acc[b].numpy(), np.array(acc))
        # the rows hold the last accepted candidate's
        last = max((k for k, a in enumerate(acc) if a), default=-1)
        expect = poses0.view(B, n, 7)[b] + (last + 1)
        assert torch.equal(s.poses.view(B, n, 7)[b], expect)
        assert torch.equal(s.r.view(B, E, 6)[b], torch.full((E, 6), float(last + 1)))
        if early_exit:
            # K9's refresh flags: built at 0 and where the reference rebuilds
            need = [it for it in range(1, iterations) if bool(s.need[it, b])]
            assert [0] + need == builds
            stuck_at_max |= bool(s.done[iterations, b]) and lams[-1] == np.float32(rules.lam_max)
    # the sequences reach both clamps
    lam = s.lam.numpy()
    assert (lam == np.float32(rules.lam_max)).any() and (lam == np.float32(rules.lam_min)).any()
    if early_exit:
        assert stuck_at_max and bool(s.done[iterations].all()) is False
