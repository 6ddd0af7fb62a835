"""PyTorch + CUDA port of uzliti_slam_tpu, slice 1: the pose-graph LM solve.

The package mirrors the JAX package's layout (``ops/lie.py``,
``graph/state.py``, ``graph/factors.py``, ``graph/tridiag.py``,
``graph/solver.py``, ``graph/oracle.py``, ``io/synthetic.py``).  Its hot
operations are hand-written CUDA kernels for Hopper (``csrc/*.cu``), built at
first use by ``kernels/_build.py`` and wrapped in ``kernels/ops.py``; on CPU
tensors the wrappers run each kernel's plain PyTorch version.  It imports
torch, numpy and scipy, never JAX.
"""
