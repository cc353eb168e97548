"""``python -m convex_optimization_tpu_torch``: the command-line driver
(``cli.py``, the counterpart of ``convex_optimization_tpu/cli.py``)."""

from convex_optimization_tpu_torch.cli import main

raise SystemExit(main())
