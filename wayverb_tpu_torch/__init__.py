"""wayverb_tpu_torch — the PyTorch + CUDA port of ``wayverb_tpu``.

The package mirrors the JAX package module for module, so each file here sits
across from its reference.  Plain tensor code is PyTorch; every kernel the
JAX package wrote in Pallas is a hand-written CUDA kernel for Hopper
(``csrc/``), built with ``nvcc`` at first use (``_build.py``).  A wrapper
given CPU tensors runs the kernel's plain PyTorch version instead; given CUDA
tensors it launches the kernel or raises.

Ported so far: the shoebox waveguide leg, ``waveguide.run.canonical`` →
``execute`` → ``run_waveguide_box`` (fused-step kernel) → ``postprocess``.
"""

__version__ = "0.1.0"
