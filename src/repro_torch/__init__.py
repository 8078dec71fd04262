"""PyTorch/CUDA port of the windowed PDF pipeline (``repro`` is the JAX
reference it is held against).

The layout mirrors ``repro``: ``core/`` (regions, distributions, Eq.-5
error, fitting, executor, pipeline), ``data/`` (simulation, loader) and
``kernels/fitpdf`` (the two hand-written CUDA kernels of the fused fit
path, sources under ``csrc/``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; the package never imports JAX.

Importing a subpackage imports nothing heavy: kernels are compiled with
``nvcc`` on their first launch (``kernels/_build.py``).
"""
