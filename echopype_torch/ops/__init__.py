"""Device ops of the port: plain torch ops and the hand-written CUDA kernels."""
