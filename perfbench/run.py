"""Run one cell of the benchmark once, on the card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints `[setup]`, `[frames]`, `[check]` (and with --trace 1 `[trace]`)
lines and the numbers compared with their limits on stderr, and one JSON
object as the last line of stdout. Exits non-zero with no result where
there is no CUDA card, where the program cannot be imported, and where a
module of JAX or of the JAX package was loaded.
"""
import os
import time

T_START = time.perf_counter()
# one process with few threads: the host's cores are shared, and the
# program's frames are bound by its one issuing thread
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def result_line(out: dict) -> str:
    """The result as the last line of stdout: one JSON object."""
    return json.dumps(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # the checkout's root, not this directory, is where packages are found
    sys.path[:] = [x for x in sys.path
                   if os.path.abspath(x or ".") != os.path.dirname(
                       os.path.abspath(__file__))]
    sys.path.insert(0, ROOT)
    import torch

    from perfbench.harness import cell, manifest

    torch.set_num_threads(1)

    chips = manifest.workload(manifest.load(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no CUDA card, or fewer than the {chips} this cell needs",
              file=sys.stderr)
        return 2
    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   root=ROOT, t_start=T_START)
    print(result_line(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
