"""PyTorch/CUDA port of the scheduling system in :mod:`repro`.

``repro_torch.core`` mirrors ``repro.core`` module for module; its
device backend runs hand-written CUDA kernels on an NVIDIA H100.  The
package imports torch and numpy, never JAX or the reference package.
"""
