"""Core library: graphs, equal-neighbor matrices, bounds, sampling, the
Algorithm-1 round functions (``rounds``) and the server (``server``).
Import the submodules directly."""
