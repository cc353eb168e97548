"""Problems, the duality gap and data generation
(counterpart of convex_optimization_tpu/core)."""
