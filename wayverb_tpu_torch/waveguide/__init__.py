"""Rectilinear FDTD waveguide mesh (PyTorch port, CUDA fused step)."""
