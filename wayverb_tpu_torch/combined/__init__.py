"""The hybrid engine: all three solvers joined at a crossover."""
