"""Hand-written CUDA kernels for sm_90a, each beside its plain PyTorch version."""
