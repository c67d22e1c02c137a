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
  models/    exact GP, batched predict routing, the batched optimizer
             (L-BFGS, Adam), the single-cell Nystrom and SVGP models and
             BFGS of the ``cell`` command
  data/      window flattening, neighborhood gather, reader, priors, binner,
             regrid and the ocean mask, synthetic seasons
  native/    the C++ host data plane (radius search, .proc parser), g++
  io/        reference-compatible pickles, quicklook NetCDFs
  pipeline/  the day, waves of days, the season
  parallel/  cell sharding: a bucket's rows over several devices, one host
             thread a shard (``--devices``)
  utils/     stage timers, the profiler trace, the locked launch counters
  csrc/      CUDA C++ sources of K1, K2 and K3 (sm_90a)
  validation.py, viz.py (figures, matplotlib), cli.py
"""

__version__ = "0.1.0"
