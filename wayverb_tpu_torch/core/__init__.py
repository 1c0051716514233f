"""Scene, geometry and acoustics primitives (PyTorch port)."""
