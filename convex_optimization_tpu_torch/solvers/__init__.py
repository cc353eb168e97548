"""Solver loops, check bookkeeping and the f64 polish
(counterpart of convex_optimization_tpu/solvers)."""
