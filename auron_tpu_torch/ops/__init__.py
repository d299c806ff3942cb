"""Physical operators and the hand-written CUDA kernels they launch."""
