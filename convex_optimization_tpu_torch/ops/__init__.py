"""Device kernels (CUDA C++ in csrc/) with their plain PyTorch versions
(counterpart of convex_optimization_tpu/ops)."""
