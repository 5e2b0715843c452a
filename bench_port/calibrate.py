"""Readings that the output checks' limits are set from, on the card.

    python3 -m bench_port.calibrate --workload <cell> --seeds 12 --control-seeds 3
    python3 -m bench_port.calibrate --workload <cell> --seeds 3 --faults [--fault NAME ...]

For each seed: the cell's scene, its loop warmed up and run for a few
iterations as a run does, the last iteration's outputs against the float32
reference (the program's readings, the lower end of each limit). For the
first ``--control-seeds`` seeds also the control: the reference computed
with TF32 camera products, in the program's place, against the float32
reference (the upper end). One JSON line per reading; then, per number,
the largest program reading and the smallest control reading. With
``--faults``, the readings of the program with each fault of its loop
kind (``FAULTS`` of ``loops/<kind>.py``, or those that ``--fault`` names)
planted instead, which the cell's limits must fail; then one line that
lists as ``uncaught`` each fault that passed every limit on some seed, and
the exit code 1 where that list is not empty.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from bench_port import harness
from bench_port.faults import planted
from bench_port.scene import build_scene


def cell_files(spec, name):
    cell = harness.workload(spec, name)
    return (harness.load_data("configs", cell["config"]),
            harness.load_data("mixes", cell["traffic"]))


def readings(spec, name, seed, control: bool, device, iterations: int = 3):
    config, mix = cell_files(spec, name)
    loop_cls = harness.load_module("loops", mix["loop"]).Loop
    scene = build_scene(config, seed, device)
    spans = harness.Spans(device)
    loop = loop_cls(scene, config, mix, device, spans)
    for _ in range(int(mix["warmup"]) + iterations):
        loop.step()
    prog = loop.outputs(seed)
    loop.release()
    del loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reference = loop_cls.reference(scene, config, mix, "float32", prog)
    out = dict(program=loop_cls.compare(prog, reference))
    if control:
        tf32 = loop_cls.reference(scene, config, mix, "tf32", prog)
        out["control"] = loop_cls.compare(tf32, reference)
    return out


def fault_summary(workload: str, lines) -> tuple[dict, int]:
    """From the ``--faults`` lines (each with ``fault`` and ``fails``, the
    limits its readings failed): the summary line, whose ``uncaught`` lists
    each fault that failed no limit on at least one seed, and the exit
    code, 1 where that list is not empty."""
    uncaught = sorted({line["fault"] for line in lines if not line["fails"]})
    return dict(workload=workload, uncaught=uncaught), int(bool(uncaught))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=2_200_000_000)
    p.add_argument("--faults", action="store_true")
    p.add_argument("--fault", action="append", default=None,
                   help="with --faults, only this fault (repeatable)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    spec = harness.load_spec()
    if args.faults:
        limits = harness.load_data("checks", args.workload)
        loop = cell_files(spec, args.workload)[1]["loop"]
        known = harness.load_module("loops", loop).FAULTS
        unknown = sorted(set(args.fault or ()) - set(known))
        if unknown:
            p.error(f"no fault {unknown} in loop kind {loop!r}: {sorted(known)}")
        lines = []
        for fault in args.fault or known:
            for i in range(args.seeds):
                seed = args.first_seed + 7919 * i
                with planted(loop, fault):
                    nums = readings(spec, args.workload, seed, False, device)["program"]
                failed = sorted(k for k in limits if not nums[k] <= limits[k])
                lines.append(dict(workload=args.workload, fault=fault, seed=seed,
                                  readings=nums, fails=failed))
                print(json.dumps(lines[-1]), flush=True)
        summary, code = fault_summary(args.workload, lines)
        print(json.dumps(summary), flush=True)
        return code
    worst, least = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        r = readings(spec, args.workload, seed, i < args.control_seeds, device)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              seconds=time.perf_counter() - t0, **r)), flush=True)
        for k, v in r["program"].items():
            worst[k] = max(worst.get(k, 0.0), float(v))
        for k, v in r.get("control", {}).items():
            least[k] = min(least.get(k, float("inf")), float(v))
    print(json.dumps(dict(workload=args.workload, program_max=worst, control_min=least)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
