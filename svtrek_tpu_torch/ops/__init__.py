"""Device ops of the port: each a CUDA kernel on CUDA tensors where the JAX
package had a Pallas kernel (the consensus K1, the POA DP K2 and traceback
K3, the step probe K4), plain PyTorch on CPU tensors; and the ops the JAX
package wrote in XLA (the CIGAR evidence walk and grouping, the window
scan, disc's run scan), plain PyTorch on the tensors' device."""
