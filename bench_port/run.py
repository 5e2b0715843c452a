"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the kernels' build or load,
the scene made from the seed, the warm-up iterations) counts from this
module's first line to the first measured iteration. ``--trace 0``
measures the closed loop for ``--seconds`` and reports the cell's
end-to-end metrics; ``--trace 1`` runs the mix's ``trace_iterations``
under ``torch.profiler`` and reports its per-layer metrics. Then the last
iteration's outputs are checked against the plain reference. The last line
of standard output is one JSON object; each number compared, beside its
limit, is also the last lines of standard error.

Exits with 2, printing no result, when no card is there (or fewer than the
cell asks for), and with 3 when JAX or the JAX package was loaded.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # transformers and other libraries would otherwise load JAX themselves.
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")

    import torch

    from bench_port import harness

    spec = harness.load_spec()
    cell = harness.workload(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = harness.run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda:0", _T_START, log=log)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"modules loaded that no run may load: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
