"""PyTorch/CUDA port of ``optimalinterpolation_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference this port is held against. The
port imports torch, numpy and scipy, and never jax or the JAX package. Its
first slice is the quicklook daily predict
(``pipeline.daily.interpolate_daily(precomputed_hypers=...)``), running
through two hand-written Hopper kernels under ``csrc/``: K1, the batched
128x128 factor + inverse (``ops/blocked_gp.py``), and K2, the fused per-cell
predict (``ops/fused_gp.py``). Module names mirror the JAX package.

Layer map:
  ops/       covariance kernels, masked linalg, blocked and fused predict,
             the CUDA build (ops/_cuda.py)
  models/    exact GP predict, batched predict routing
  data/      window flattening, neighborhood gather, reader, prior, synthetic
  io/        reference-compatible pickles
  pipeline/  the quicklook daily field
  csrc/      CUDA C++ sources of K1 and K2 (sm_90a)
"""

__version__ = "0.1.0"
