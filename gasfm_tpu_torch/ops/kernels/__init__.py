"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version and its launch counter (``<wrapper>.launches``)."""
