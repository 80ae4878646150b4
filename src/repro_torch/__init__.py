"""PyTorch/CUDA port of the ``repro`` package, one slice at a time.

The JAX package under ``src/repro`` is the reference; this package mirrors
its layout and names so each module's counterpart is found by path. It
imports ``torch`` and numpy, never ``jax`` and never ``repro``. Attention
on a CUDA tensor runs through the hand-written Hopper kernels in
``repro_torch.kernels``; on a CPU tensor it takes their plain versions.

Ported so far: the dense-family stage-serving data plane (``models``,
``nn``, ``kernels``, ``serving.engine``/``serving.batcher``,
``launch.serve``'s single-arch decode mode), and the control half without
learning (``core.mdp``/``controller``/``expert``/``baselines``, ``cluster``,
``serving.arrivals``/``telemetry``/``runtime``, ``api``, the launcher's
``--pipeline`` mode), NumPy as in the reference, and the OPD agent
(``core.features``/``policy``/``predictor``/``ppo``/``opd``, the vectorized
analytic env ``core.vecenv``, ``nn.resnet``/``lstm``, ``train.optim``),
which trains and decides on a torch device.
"""
