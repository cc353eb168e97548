"""Column-sharded solvers over torch.distributed (counterpart of
convex_optimization_tpu/parallel: its column layout)."""
