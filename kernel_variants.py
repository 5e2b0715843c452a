#!/usr/bin/env python3
"""Time source variants of the port's CUDA kernels on their main paths' inputs.

Run from the repository root, on a machine with one CUDA card:

    python3 kernel_variants.py DIR [DIR ...]

Each DIR holds its own copy of any of the package's kernel sources in
``dmesh2_renderer_tpu_torch/csrc``, with the same C interfaces (a source
variant, e.g. with one design lever reverted): ``pack_stream.cu``,
``peel.cu``, or ``composite_fwd.cu`` / ``composite_bwd.cu`` beside their
``pair_math.cuh``. The script captures every kernel's inputs from the main
paths ``chip_smoke.py`` drives, through the package's own kernels: one
training step on the 1M-triangle 1920x1080 scene (``pack_stream`` and the
compositors), one ``LayeredRenderer.generate`` on tet_grid(32), two views
at 1920x1080, 8 layers (``peel``), and ``chip_smoke.py``'s phase-2 backward
of icosphere(3), whose faces cover many pixels each (``composite_bwd_ico``).
It builds every DIR's kernels (all nvcc runs at once) and times each kernel
of each source on those inputs:
``--rounds`` rounds, each timing every source in turn (median of ``--reps``
CUDA-event runs), so drift spreads over all of them. A variant nvcc refuses
is reported and left out. Each variant's output
must equal the package kernel's bit for bit (``composite_bwd``: hold
``chip_smoke.py``'s per-column tolerances against the plain version).
Prints the plain backward's work counts on both backward inputs, one JSON
line per source (ptxas resources, medians of the rounds and every round) and
the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch


def build_or_report(kernel) -> bool:
    """Build ``kernel``; a variant that nvcc refuses is reported and left
    out of the timings."""
    try:
        kernel.build()
        return True
    except RuntimeError as err:
        print(f"{kernel.source}: {err}", file=sys.stderr)
        return False


def same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available", file=sys.stderr)
        return 2

    import numpy as np

    import chip_smoke as cs
    from dmesh2_renderer_tpu_torch import (
        LayeredRenderer, RasterConfig, Renderer, functional, render_partial)
    from dmesh2_renderer_tpu_torch.ops import _kernels
    from dmesh2_renderer_tpu_torch.ops.binning import pack_stream
    from dmesh2_renderer_tpu_torch.ops.composite_bwd import (
        composite_backward, composite_backward_plain)
    from dmesh2_renderer_tpu_torch.ops.composite_fwd import composite_forward
    from dmesh2_renderer_tpu_torch.ops.peel import peel_layers
    from dmesh2_renderer_tpu_torch.utils.meshes import icosphere, orbit_cameras

    dev = torch.device("cuda")
    card = cs.nvidia_smi_line()
    sz = cs.Sizes()
    s, mv, proj, config = cs.headline_scene(dev, sz)
    renderer = Renderer(mv, proj, sz.width, sz.height, config=config)
    p = cs.leaves_of(s)
    with cs.captured_kernel_calls() as calls:
        color, depth = renderer.forward([0], [[0, 0]], sz.width, sz.height, p["verts"],
                                        s["faces"], p["verts_color"], p["faces_opacity"],
                                        p["faces_intense"], s["background"], 1.0)
        (color.sum() + depth.sum()).backward()
    scene, lmv, lproj, lconfig = cs.layered_scene(sz)
    lr = LayeredRenderer(lmv, lproj, sz.width, sz.height, config=lconfig)
    with cs.captured_kernel_calls(functional, ("peel_layers",)) as layered_calls:
        lr.generate(list(range(sz.layered_views)),
                    *(torch.as_tensor(x, device=dev) for x in scene), sz.layered_layers)
    # Phase 2's backward: icosphere(3), 4 views at 512x512, a ragged window,
    # a loss on colour, depth and final_t.
    rng = np.random.default_rng(0)
    verts, faces = icosphere(sz.check_subdiv)
    cmv, cproj = orbit_cameras(sz.check_views)
    ico = cs.scene_tensors(verts, faces, sz.check_views, rng, dev)
    x0, y0, pw, ph = sz.check_window
    weights = [torch.as_tensor(rng.normal(size=(sz.check_views, ph, pw) + c).astype(np.float32),
                               device=dev) for c in ((3,), (), ())]
    q = cs.leaves_of(ico)
    with cs.captured_kernel_calls(names=("composite_backward",)) as ico_calls:
        outs = render_partial(q["verts"], ico["faces"], q["verts_color"],
                              q["faces_opacity"], q["faces_intense"], cmv, cproj,
                              ico["background"], sz.check_res, sz.check_res, 1.0,
                              RasterConfig(binning_capacity=1 << 16),
                              patch_origin=(x0, y0), patch_shape=(ph, pw))
        sum((o * w).sum() for o, w in zip(outs[:3], weights)).backward()
    # case -> (_kernels attribute, wrapper, (captured arguments, package output))
    paths = {
        "pack_stream": ("PACK_STREAM", pack_stream, calls["pack_stream"]),
        "composite_fwd": ("COMPOSITE_FWD", composite_forward, calls["composite_forward"]),
        "composite_bwd": ("COMPOSITE_BWD", composite_backward, calls["composite_backward"]),
        "composite_bwd_ico": ("COMPOSITE_BWD", composite_backward,
                              ico_calls["composite_backward"]),
        "peel": ("PEEL", peel_layers, layered_calls["peel_layers"]),
    }
    bwd_plain = {}
    for case in ("composite_bwd", "composite_bwd_ico"):
        work = {}
        bwd_plain[case] = composite_backward_plain(*paths[case][2][0], work=work)
        print(json.dumps(dict(work=case, **{k: int(v) for k, v in work.items()})))

    package = {attr: getattr(_kernels, attr) for attr, _, _ in paths.values()}
    sources = {"package": package}
    for d in args.dirs:
        variant = {}
        for attr, k in package.items():
            if (d / k.source.name).exists():
                variant[attr] = _kernels.Kernel(
                    k.name, str((d / k.source.name).resolve()), k.argtypes,
                    extra_flags=k.flags[len(_kernels.NVCC_FLAGS):])
        if not variant:
            raise SystemExit(f"{d} holds none of the kernel sources")
        sources[str(d)] = variant
    kernels = [k for ks in sources.values() for k in ks.values()]
    with ThreadPoolExecutor(len(kernels)) as pool:
        built = list(pool.map(build_or_report, kernels))
    failed = {k for k, ok in zip(kernels, built) if not ok}
    if failed & set(package.values()):
        raise RuntimeError("a package kernel did not build")
    sources = {name: {a: k for a, k in ks.items() if k not in failed}
               for name, ks in sources.items()}

    def run(case, kernel):
        attr, fn, (a, _) = paths[case]
        setattr(_kernels, attr, kernel)
        try:
            return fn(*a)
        finally:
            setattr(_kernels, attr, package[attr])

    # source -> case -> kernel
    cases = {name: {case: ks[attr] for case, (attr, _, _) in paths.items() if attr in ks}
             for name, ks in sources.items()}
    for name, ks in cases.items():
        for case, k in ks.items():
            out = run(case, k)
            if case in bwd_plain:
                cs.compare_backward(cs.in_prefixes(paths[case][2][0], out),
                                    bwd_plain[case], f"{name} {case}")
            elif not same(out, paths[case][2][1]):
                raise AssertionError(f"{name}: {k.name} differs from the package kernel")
    times = {name: {case: [] for case in ks} for name, ks in cases.items()}
    for _ in range(args.rounds):
        for name, ks in cases.items():
            for case, k in ks.items():
                times[name][case].append(
                    cs.time_ms(lambda: run(case, k), args.reps)[0])
    for name, ks in sources.items():
        print(json.dumps(dict(
            source=name,
            ptxas={k.name: [ln.strip() for ln in k.build_log.splitlines()
                            if "registers" in ln or "spill" in ln] for k in ks.values()},
            ms={case: statistics.median(t) for case, t in times[name].items()},
            rounds_ms=times[name])))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
