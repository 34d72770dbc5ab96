"""Device operations: deploy-time tables, the automaton and its CUDA kernels."""
