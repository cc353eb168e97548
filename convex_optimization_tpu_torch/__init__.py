"""convex_optimization_tpu_torch — the PyTorch/CUDA port of
``convex_optimization_tpu`` (the JAX package beside it is the reference).

Solves the same composite problems

    min_x  P(x) = 0.5 * ||A x - b||_2^2 + (lam2 / 2) * ||x||_2^2 + g(x)

with the same certified duality gap.  Ported so far: the main path of
``bench.py`` (host data generation, the block-coordinate-descent solve over
the transposed block-major layout ``A_t`` (n/B, B, m), the float64 support
polish), FISTA/ISTA, the working-set solver (``fista_ws``, ``bcd_ws``),
ADMM, gap-safe screening, the warm-started (FISTA, BCD, working-set,
ADMM, compacting) and batched lambda paths, K-fold CV, and the
column-sharded solvers: every single-device method and path mode of the
JAX package's ``solve`` and ``lambda_path``.  Its
device kernels are CUDA C++ for Hopper (``csrc/``); every kernel wrapper
also has a plain PyTorch version, which runs for CPU tensors and serves as
the kernel's oracle.

Layout mirrors the JAX package:

    api        solve() / Result
    solvers/   bcd, FISTA, working-set and ADMM loops, screening, lambda
               paths (sequential, batched, compacting), K-fold CV, check
               bookkeeping, f64 polish
    ops/       kernel wrappers + plain versions, nvcc build
    core/      Problem, duality gap, host data generation
    models/    penalty families
    utils/     device policy, native host runtime binding
"""

from convex_optimization_tpu_torch.utils.device import (
    require_cuda,
    set_precision_flags,
)

set_precision_flags()

from convex_optimization_tpu_torch.core.problem import (  # noqa: E402
    Problem,
    make_problem,
    problem_from_numpy,
)
from convex_optimization_tpu_torch.core import datagen  # noqa: E402
from convex_optimization_tpu_torch.core.objective import (  # noqa: E402
    duality_gap,
    lambda_max,
)
from convex_optimization_tpu_torch.models.penalties import (  # noqa: E402
    Penalty,
    group_l2,
    l1,
    nonneg_l1,
)
from convex_optimization_tpu_torch.api import Result, solve  # noqa: E402
from convex_optimization_tpu_torch.solvers.polish import (  # noqa: E402
    polish_support,
)
from convex_optimization_tpu_torch.solvers.lambda_path import (  # noqa: E402
    PathResult,
    lambda_path,
)
from convex_optimization_tpu_torch.solvers.batched_path import (  # noqa: E402
    batched_lambda_path,
)
from convex_optimization_tpu_torch.solvers.cv import (  # noqa: E402
    CVResult,
    cv_lambda_path,
)

__version__ = "0.1.0"

__all__ = [
    "Problem",
    "make_problem",
    "problem_from_numpy",
    "Penalty",
    "l1",
    "nonneg_l1",
    "group_l2",
    "datagen",
    "duality_gap",
    "lambda_max",
    "solve",
    "Result",
    "polish_support",
    "lambda_path",
    "batched_lambda_path",
    "cv_lambda_path",
    "PathResult",
    "CVResult",
    "require_cuda",
]
