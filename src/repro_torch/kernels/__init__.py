"""Hand-written CUDA kernels of the port's LM substrate, the twins of
:mod:`repro.kernels`.

  * :mod:`.flash_attention` — causal or full GQA attention forward.
  * :mod:`.ssm_scan` — the Mamba-1 selective scan.

Each subpackage has ``ops.py`` (the public function), ``kernel.py`` (the
wrapper that launches the CUDA kernel in ``csrc/`` on CUDA tensors and
runs the plain version on CPU tensors, with its ``LAUNCHES`` count) and
``ref.py`` (the plain PyTorch version).  Nothing here imports a kernel
library or ``nvcc`` until a CUDA tensor is launched on.
"""
