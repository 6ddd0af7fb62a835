"""PyTorch + CUDA port of uzliti_slam_tpu: the pose-graph LM solve (slice 1),
the optimization epoch (slice 2, ``pipeline.optimize_epoch``), the
occupancy projection (slice 3, ``pipeline.project_map``) and the keyframe
front-end (slice 4, ``pipeline.keyframe_frontend``).

The package mirrors the JAX package's layout (``ops/lie.py``,
``ops/ransac.py``, ``ops/features.py``, ``ops/scan.py``,
``ops/matching.py``, ``frontend/camera.py``, ``graph/state.py``,
``graph/factors.py``, ``graph/tridiag.py``, ``graph/solver.py``,
``graph/oracle.py``, ``graph/shortest_path.py``, ``graph/filter.py``,
``mapping/occupancy.py``, ``io/synthetic.py``, ``io/simulator.py``,
``config.py``, ``pipeline.py``), plus ``ops/resize.py`` (the reference's
antialiased linear resize) and ``ops/_patterns.py`` (the BRIEF patterns as
data).  Constructors and entry points run on the CUDA card unless given
``device=``.  Its hot operations are hand-written CUDA kernels for Hopper
(``csrc/*.cu``), built at first use by ``kernels/_build.py`` and wrapped in
``kernels/ops.py``; on CPU tensors the wrappers run each kernel's plain
PyTorch version.  It imports torch, numpy and scipy, never JAX.
"""
