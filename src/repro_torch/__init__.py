"""PyTorch/CUDA port of the ``repro`` package, one slice at a time.

The JAX package under ``src/repro`` is the reference; this package mirrors
its layout and names so each module's counterpart is found by path. It
imports ``torch`` and numpy, never ``jax`` and never ``repro``. Attention
on a CUDA tensor runs through the hand-written Hopper kernels in
``repro_torch.kernels``; on a CPU tensor it takes their plain versions.

Every module of the reference has its counterpart here, but for the jax
version shim (``repro/compat.py``) and ``launch/hlo_cost.py``, whose job
``launch/step_cost.py`` does over the eager program: the model zoo and its
serving and training steps, the MDP and both envs, the OPD agent and its
vectorized twins, forecasting and proactive control, the fleet, measured
stage execution and calibration, placement and the dry run, the
control-plane API, the paper's figures and the throughput benchmarks
(``launch/*``, all run by ``launch/run.py``), and the static checks and
runtime sanitizer of ``analysis``. What needs more than one card (the
sequence- and expert-parallel paths, the collective term) is not ported.
"""
