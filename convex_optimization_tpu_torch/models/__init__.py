"""Penalty families (counterpart of convex_optimization_tpu/models)."""
