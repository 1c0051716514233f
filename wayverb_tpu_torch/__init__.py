"""wayverb_tpu_torch — the PyTorch + CUDA port of ``wayverb_tpu``.

The package mirrors the JAX package module for module, so each file here sits
across from its reference.  Plain tensor code is PyTorch; every kernel the
JAX package wrote in Pallas is a hand-written CUDA kernel for Hopper
(``csrc/``), built with ``nvcc`` at first use (``_build.py``).  A wrapper
given CPU tensors runs the kernel's plain PyTorch version instead; given CUDA
tensors it launches the kernel or raises.

Ported so far: the hybrid engine on one device and one band
(``combined.engine.Engine.run`` → ``render``) for a shoebox or any closed
triangle soup (``core.scene.load_scene`` reads one from a model file), with
the shoebox and the general waveguide and their gradients, and the ray
tracer on the dense broadcast, the Möller–Trumbore kernels or the voxel DDA
(``raytracer.accel.auto_accel``).
"""

__version__ = "0.1.0"
