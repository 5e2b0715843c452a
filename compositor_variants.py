#!/usr/bin/env python3
"""Time variants of the compositor kernels on the headline training step.

Run from the repository root, on a machine with one CUDA card:

    python3 compositor_variants.py DIR [DIR ...]

Each DIR holds its own ``composite_fwd.cu``, ``composite_bwd.cu`` and
``pair_math.cuh`` with the C interface of
``dmesh2_renderer_tpu_torch/csrc``'s (a source variant, e.g. with one design
lever reverted). The script captures the compositors' inputs from one
training step on ``chip_smoke.py``'s 1M-triangle 1920x1080 scene (through
the package's own kernels), builds every DIR's two kernels (all nvcc runs at
once) and times each kernel of each DIR and of the package on those inputs:
``--rounds`` rounds, each timing every source in turn (median of ``--reps``
CUDA-event runs), so drift spreads over all of them. Each variant's forward
must equal the package kernel's output bit for bit and its backward must
hold ``chip_smoke.py``'s per-column tolerances against the plain version.
Prints one JSON line per source (ptxas resources, medians of the rounds and
every round) and the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compositor_variants: no CUDA device is available", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from dmesh2_renderer_tpu_torch.ops import _kernels
    from dmesh2_renderer_tpu_torch.ops.composite_bwd import (
        composite_backward, composite_backward_plain)
    from dmesh2_renderer_tpu_torch.ops.composite_fwd import composite_forward

    dev = torch.device("cuda")
    card = cs.nvidia_smi_line()
    sz = cs.Sizes()
    s, mv, proj, config = cs.headline_scene(dev, sz)
    from dmesh2_renderer_tpu_torch import Renderer
    renderer = Renderer(mv, proj, sz.width, sz.height, config=config)
    p = cs.leaves_of(s)
    with cs.captured_kernel_calls() as calls:
        color, depth = renderer.forward([0], [[0, 0]], sz.width, sz.height, p["verts"],
                                        s["faces"], p["verts_color"], p["faces_opacity"],
                                        p["faces_intense"], s["background"], 1.0)
        (color.sum() + depth.sum()).backward()
    fwd_args, fwd_ref = calls["composite_forward"]
    bwd_args, _ = calls["composite_backward"]
    bwd_plain = composite_backward_plain(*bwd_args)

    package = (_kernels.COMPOSITE_FWD, _kernels.COMPOSITE_BWD)
    sources = {"package": package}
    for d in args.dirs:
        sources[str(d)] = tuple(
            _kernels.Kernel(k.name, str((d / k.source.name).resolve()), k.argtypes,
                            extra_flags=k.flags[len(_kernels.NVCC_FLAGS):])
            for k in package)
    kernels = [k for pair in sources.values() for k in pair]
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(_kernels.Kernel.build, kernels))

    def run(pair, fn, a):
        _kernels.COMPOSITE_FWD, _kernels.COMPOSITE_BWD = pair
        try:
            return fn(*a)
        finally:
            _kernels.COMPOSITE_FWD, _kernels.COMPOSITE_BWD = package

    times = {name: {"fwd": [], "bwd": []} for name in sources}
    for name, pair in sources.items():
        out = run(pair, composite_forward, fwd_args)
        if not all(torch.equal(a, b) for a, b in zip(out, fwd_ref)):
            raise AssertionError(f"{name}: composite_fwd differs from the package kernel")
        cs.compare_backward(run(pair, composite_backward, bwd_args), bwd_plain, name)
    for _ in range(args.rounds):
        for name, pair in sources.items():
            for key, fn, a in (("fwd", composite_forward, fwd_args),
                               ("bwd", composite_backward, bwd_args)):
                times[name][key].append(
                    cs.time_ms(lambda: run(pair, fn, a), args.reps)[0])
    for name, pair in sources.items():
        print(json.dumps(dict(
            source=name,
            ptxas={k.name: [ln.strip() for ln in k.build_log.splitlines()
                            if "registers" in ln or "spill" in ln] for k in pair},
            fwd_ms=statistics.median(times[name]["fwd"]),
            bwd_ms=statistics.median(times[name]["bwd"]),
            fwd_rounds_ms=times[name]["fwd"], bwd_rounds_ms=times[name]["bwd"])))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
