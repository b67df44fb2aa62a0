"""The control of `correct`: the plain reference computed in bfloat16 (the
precision below the configurations' float32) put in the program's place,
judged by the same comparison as a run. It must come out not correct.

    python3 perfbench/control.py --workload <name> --seeds 11,12,13

For each seed: the pixels and frames a run of that seed would check (for
path tracing its first `check_frames` frames), rendered by the reference
in bfloat16, the control, and judged as a run's are: against the reference
in float32, whose light pass is compared with the control's too. Prints
one JSON line a seed with the control's numbers beside the cell's limits.
Not run by the benchmark's own runs.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reading(workload: str, seed: int, root: str, device) -> dict:
    import torch

    from perfbench.harness import cell, check, inputs, manifest

    man = manifest.load(root)
    wl = manifest.workload(man, workload)
    cfg = manifest.config(man, wl["config"], root)
    traffic = manifest.traffic(wl["traffic"], root)
    limits = manifest.limits(workload, root)
    path = inputs.scene_path(cfg, root)
    width, height = cfg["image"]
    arrays = {}
    if traffic["algorithm"] == "spcbpt":
        arrays = inputs.host_copy(inputs.state_arrays(
            seed, inputs.geometry(path), device))
    first = cell.first_subframe(seed)
    if traffic["algorithm"] == "spcbpt":
        subframes = [first + check.pick_frames(seed, check.LV_SPAN, 1)[0]]
    else:
        subframes = [first + j for j in range(int(traffic["check_frames"]))]
    pixels = check.pick_pixels(seed, width * height, device)
    low, low_lvs = check.reference_frames(
        traffic, path, width, height, subframes, pixels, arrays, device,
        dtype=torch.bfloat16)
    ref, ref_lvs = check.reference_frames(
        traffic, path, width, height, subframes, pixels, arrays, device)
    numbers = dict(check.compare(low, ref), count_errors=0)
    if low_lvs is not None:
        numbers.update(check.compare_light(low_lvs, ref_lvs))
    correct, compared = check.judge(numbers, limits)
    return {"workload": workload, "seed": seed, "correct": correct,
            **numbers, "compared": compared}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0) if args.device == "cuda" else \
        torch.device("cpu")
    for s in args.seeds.split(","):
        print(json.dumps(reading(args.workload, int(s), ROOT, dev)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
