"""Hand-written CUDA kernels of the port, their wrappers (:mod:`.ops`)
and their plain PyTorch versions (:mod:`.ref`)."""
