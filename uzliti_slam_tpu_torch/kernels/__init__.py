"""Hand-written CUDA kernels: build (``_build``) and wrappers (``ops``)."""
