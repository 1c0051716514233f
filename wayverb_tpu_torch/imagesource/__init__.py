"""Image-source solvers: traced-path validation and the shoebox lattice."""
