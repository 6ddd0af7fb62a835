"""PyTorch + CUDA port of uzliti_slam_tpu: the pose-graph LM solve (slice 1)
and the optimization epoch (slice 2, ``pipeline.optimize_epoch``).

The package mirrors the JAX package's layout (``ops/lie.py``,
``ops/ransac.py``, ``graph/state.py``, ``graph/factors.py``,
``graph/tridiag.py``, ``graph/solver.py``, ``graph/oracle.py``,
``graph/shortest_path.py``, ``graph/filter.py``, ``io/synthetic.py``,
``config.py``, ``pipeline.py``).  Constructors build on the CUDA card
unless given ``device=``.  Its hot
operations are hand-written CUDA kernels for Hopper (``csrc/*.cu``), built at
first use by ``kernels/_build.py`` and wrapped in ``kernels/ops.py``; on CPU
tensors the wrappers run each kernel's plain PyTorch version.  It imports
torch, numpy and scipy, never JAX.
"""
