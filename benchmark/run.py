"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  One process: load the program's kernel
library, make the cell's data on the card from the seed, hand it to the
program, warm up the cell's own entry, run the measured window of whole
requests, then judge every request's output against the plain reference
and print one JSON line last on stdout.  ``--trace 1`` reports the cell's
per-layer metrics instead of its end-to-end ones, and profiles one request.

Exits non-zero, printing no result, without a card (or fewer than the cell
asks for), without the program in this checkout, or where the process
holds a module of the JAX package (or JAX) once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
PROGRAM = "convex_optimization_tpu_torch"
#: top-level module names that nothing the benchmark runs may import
FORBIDDEN = ("jax", "jaxlib", "flax", "convex_optimization_tpu", "bench",
             "chip_smoke")
#: fixed cache directories inside the checkout, so that only a cell's
#: first run in a checkout builds anything
CACHES = {"TORCH_EXTENSIONS_DIR": "build/bench_cache/torch_extensions",
          "TRITON_CACHE_DIR": "build/bench_cache/triton",
          "CUDA_CACHE_PATH": "build/bench_cache/cuda"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def fail(msg: str, code: int = 2) -> None:
    log(f"benchmark: {msg}")
    sys.exit(code)


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def import_program():
    """The program of this checkout; never one installed elsewhere."""
    sys.path.insert(0, ROOT)
    try:
        import convex_optimization_tpu_torch as cot
    except ImportError as e:
        fail(f"the program {PROGRAM} is not in this checkout ({e})")
    where = os.path.realpath(cot.__file__)
    if not where.startswith(os.path.realpath(ROOT) + os.sep):
        fail(f"{PROGRAM} was imported from {where}, outside {ROOT}")
    return cot


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse(argv)
    for key, rel in CACHES.items():
        os.environ[key] = os.path.join(ROOT, rel)
    sys.path.insert(0, BENCH_DIR)
    from benchlib import spec

    try:
        cell = spec.find_cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        fail(f"cannot find the cell: {e}")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA card: the benchmark measures the card only")
    if torch.cuda.device_count() < cell.chips:
        fail(f"the cell needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} present")
    cot = import_program()
    from benchlib import cell_run

    result, check_lines = cell_run.run(
        cot, cell, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device=torch.device("cuda", 0),
        t_process=T_PROCESS)
    bad = forbidden_modules()
    if bad:
        fail(f"the process holds forbidden modules: {', '.join(bad)}")
    log(f"card: {power_limit()}")
    for line in check_lines:
        log(line)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
