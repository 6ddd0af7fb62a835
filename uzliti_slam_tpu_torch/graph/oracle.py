"""Sparse-Cholesky Gauss-Newton oracle — the g2o-equivalent reference.

PyTorch counterpart of ``uzliti_slam_tpu/graph/oracle.py``: scipy sparse
GN/LM over the robustified normal equations, built from the port's own
pose-form factors on CPU tensors.  It is the quality bar the card's solves
are held to ("what g2o would have returned").
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from uzliti_slam_tpu_torch.graph import factors, solver
from uzliti_slam_tpu_torch.ops import lie


def sparse_gn_oracle(g, iters: int = 12, lm: bool = False,
                     lambda_init: float = 1e-4) -> torch.Tensor:
    """Sparse Gauss-Newton (``lm=False``) or Levenberg-Marquardt
    (``lm=True``: λ·diag(H) damping with accept/reject, as g2o) on the
    robustified normal equations.  Runs on the CPU whatever ``g``'s device;
    returns the solved poses (N, 7) on the CPU."""
    g = g.to("cpu")
    labels = solver.connected_components(g)
    gauge = solver.gauge_fix_mask(g, labels).numpy()
    n = g.node_capacity
    free = np.repeat(g.node_valid.numpy() & ~gauge, 6)
    poses = g.pose
    ef = g.e_from.long()
    et = g.e_to.long()
    ef_np, et_np = ef.numpy(), et.numpy()
    lam = lambda_init
    chi2_cur = float(solver.total_chi2(g, poses, 1.0)) if lm else None

    def block_coo(rows6, cols6, blocks):
        rr = 6 * rows6[:, None, None] + np.arange(6)[None, :, None]
        cc = 6 * cols6[:, None, None] + np.arange(6)[None, None, :]
        return (
            np.broadcast_to(rr, blocks.shape).ravel(),
            np.broadcast_to(cc, blocks.shape).ravel(),
            blocks.ravel(),
        )

    for _ in range(iters):
        r, Ji, Jj = factors.edge_residual_jacobians(poses[ef], poses[et], g.e_transform)
        W = solver._weighted_info(g, r, 1.0).numpy()
        r, Ji, Jj = r.numpy(), Ji.numpy(), Jj.numpy()
        JiT = Ji.transpose(0, 2, 1)
        JjT = Jj.transpose(0, 2, 1)
        Hii = JiT @ W @ Ji
        Hij = JiT @ W @ Jj
        Hjj = JjT @ W @ Jj
        bi = (JiT @ (W @ r[..., None]))[..., 0]
        bj = (JjT @ (W @ r[..., None]))[..., 0]
        parts = [
            block_coo(ef_np, ef_np, Hii),
            block_coo(ef_np, et_np, Hij),
            block_coo(et_np, ef_np, Hij.transpose(0, 2, 1)),
            block_coo(et_np, et_np, Hjj),
        ]
        rows = np.concatenate([p[0] for p in parts])
        cols = np.concatenate([p[1] for p in parts])
        vals = np.concatenate([p[2] for p in parts])
        H = sp.coo_matrix((vals, (rows, cols)), shape=(6 * n, 6 * n)).tocsr()
        b = np.zeros(6 * n)
        np.add.at(b, (6 * ef_np[:, None] + np.arange(6)[None]).ravel(), bi.ravel())
        np.add.at(b, (6 * et_np[:, None] + np.arange(6)[None]).ravel(), bj.ravel())

        Hf = H[free][:, free] + 1e-8 * sp.eye(int(free.sum()), format="csr")
        dx = np.zeros(6 * n)
        if lm:
            diag = sp.diags(np.maximum(Hf.diagonal(), 1e-6))
            dx[free] = spla.spsolve((Hf + lam * diag).tocsc(), -b[free])
            cand = lie.pose_retract(poses, torch.from_numpy(dx.reshape(-1, 6)).float())
            chi2_new = float(solver.total_chi2(g, cand, 1.0))
            if chi2_new < chi2_cur:
                poses, chi2_cur = cand, chi2_new
                lam = max(lam / 3.0, 1e-9)
            else:
                lam = min(lam * 3.0, 1e2)
        else:
            dx[free] = spla.spsolve(Hf.tocsc(), -b[free])
            poses = lie.pose_retract(poses, torch.from_numpy(dx.reshape(-1, 6)).float())
    return poses
