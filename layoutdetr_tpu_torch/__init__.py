"""PyTorch/CUDA port of LayoutDETR-TPU for one NVIDIA H100.

Mirrors the module names of ``layoutdetr_tpu`` (the JAX reference) and
imports nothing of it. Entry points run on ``device="cuda"`` unless the
caller passes another device; the TPU kernels become hand-written
Hopper kernels under ``ops/`` (CUDA sources in ``ops/csrc/``).
"""
