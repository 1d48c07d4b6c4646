"""PyTorch + CUDA port of the multi-function Monte-Carlo integrator.

``repro_torch`` mirrors ``repro``'s layout (``core/``, ``kernels/``,
``distributed/``, ``launch/``) and is held against it by the tests.  It
imports ``torch`` and ``numpy``, never ``jax`` and nothing of ``repro``.
The fused multi-family kernel is hand-written CUDA for Hopper
(``kernels/csrc/fused_mc.cu``); its plain PyTorch version runs on CPU
tensors.  Entry points take a ``device`` argument that defaults to
``"cuda"`` (see :mod:`repro_torch.device`).
"""
