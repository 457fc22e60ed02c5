"""Device ops of the port: the consensus (kernel K1 on CUDA tensors, plain
PyTorch on CPU tensors) and the audit step that feeds it."""
