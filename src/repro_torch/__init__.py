"""PyTorch/CUDA port of the WideSA reproduction for one NVIDIA H100.

A package of its own beside the JAX reference (``repro``): it imports
``torch`` and numpy, never JAX and nothing of ``repro``.  The planner is
copied into ``core/``; the GEMMs of the serving path run on hand-written
Hopper kernels (``kernels/csrc``); entry points take a ``device`` that
defaults to ``"cuda"``.
"""
