"""Float32 rate calibration on the card: the quadratic map x <- a - x*x.

Counterpart of ``benchmarks/micro_vpu.py`` (its Pallas kernel
``make_kernel.kernel``): no module of the JAX package holds this function.
For a float32 block ``x``, ``a = x * 1e-7 + 1.62``, then ``iters`` times
``x = a - x*x``; the final ``x`` is the output. The map has no closed form,
so a compiler can neither fold the loop away nor reassociate it, and every
iteration costs 2 float32 operations per element.

``quad_map`` launches ``csrc/quad_map.cu`` on a CUDA tensor: its
uncontracted instance, which rounds the product and the difference apart
as every port kernel does (they are built with ``-fmad=false``), or, with
``contract=True``, its contracted instance, one fused multiply-add per
iteration. ``fp32_rate`` times both at two iteration counts; the slope
between them gives the operations per second with the launch overhead
cancelled. The data-sheet float32 peak counts an FMA as two operations, so
it is the contracted instance's ceiling; the uncontracted one shows what a
kernel that never contracts can reach.

The map is chaotic at a = 1.62: a one-ulp difference roughly doubles at each
step, so implementations that round differently agree only at small
``iters``. Values that start in ``[a - a^2, a]`` stay there.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import time

import torch

from dmesh2_renderer_tpu_torch.ops import _kernels

# micro_vpu.py's block and iteration counts.
SHAPE = (512, 1024)
L_LO, L_HI = 2048, 16384
OPS_PER_ITER = 2                  # one multiply and one subtract per element
MAX_ITERS = 1 << 30
# Timing: trials of REPS back-to-back launches each, the two counts in turns.
REPS = 50
TRIALS = 5
# Each trial is queued behind one launch of BUSY_ITERS iterations (a few ms
# on an H100), so the card runs the timed launches back to back however
# slowly the host enqueues them.
BUSY_ITERS = 1 << 18
# The SM clock is read while LOAD_LAUNCHES launches of LOAD_ITERS iterations
# (about 0.1 s each on an H100) keep the card busy.
LOAD_ITERS = 1 << 22
LOAD_LAUNCHES = 12


def quad_map_plain(x, iters: int):
    """Plain version: separate tensor operations, each rounded."""
    a = x * 1e-7 + 1.62
    for _ in range(iters):
        x = a - x * x
    return x


def quad_map(x, iters: int, contract: bool = False):
    """``iters`` steps of x <- a - x*x, a = x * 1e-7 + 1.62, elementwise.

    CPU tensors take the plain version (the uncontracted function; the
    contracted instance has none and raises there); CUDA tensors launch
    ``csrc/quad_map.cu``'s uncontracted instance, or its contracted one with
    ``contract``.
    """
    if not 0 <= iters <= MAX_ITERS:
        raise ValueError(f"iters must lie in [0, {MAX_ITERS}], got {iters}")
    dev = x.device
    if dev.type == "cpu":
        if contract:
            raise ValueError("the contracted quad_map runs on CUDA tensors only")
        if x.dtype != torch.float32:
            raise ValueError(f"x must be torch.float32, got {x.dtype}")
        return quad_map_plain(x, iters)
    _kernels.check_inputs(dev, [("x", x, torch.float32, tuple(x.shape))])
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _kernels.QUAD_MAP.load()
    P = ctypes.c_void_p
    with torch.cuda.device(dev):
        err = lib.quad_map_launch(P(x.data_ptr()), x.numel(), iters, int(contract),
                                  P(out.data_ptr()), _kernels.current_stream(dev))
    _kernels.QUAD_MAP.launched(err)
    return out


def nvidia_smi(fields: str, index: int) -> list[str]:
    """The comma-separated ``nvidia-smi --query-gpu`` values of card
    ``index``, as strings."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", f"--query-gpu={fields}",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]


def _ms_per_launch(x, iters: int, contract: bool) -> float:
    """Milliseconds per launch over REPS back-to-back launches (CUDA events),
    queued behind an untimed BUSY_ITERS launch."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    quad_map(x, BUSY_ITERS, contract)
    start.record()
    for _ in range(REPS):
        quad_map(x, iters, contract)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def _rate(x, contract: bool) -> dict:
    """Median ms per launch at L_LO and L_HI over TRIALS trials in turns;
    the operations per second from the slope and the launch overhead on the
    card (the line's intercept at 0 iterations)."""
    for iters in (L_LO, L_HI):           # warm-up
        quad_map(x, iters, contract)
    torch.cuda.synchronize()
    lo, hi = [], []
    for _ in range(TRIALS):
        lo.append(_ms_per_launch(x, L_LO, contract))
        hi.append(_ms_per_launch(x, L_HI, contract))
    ms_lo, ms_hi = statistics.median(lo), statistics.median(hi)
    slope_ms = (ms_hi - ms_lo) / (L_HI - L_LO)        # ms per iteration
    d_ops = OPS_PER_ITER * x.numel() * (L_HI - L_LO)
    return dict(
        ops_per_s=d_ops / ((ms_hi - ms_lo) * 1e-3) if ms_hi > ms_lo else float("nan"),
        overhead_us=(ms_lo - L_LO * slope_ms) * 1e3,
        ms_lo=ms_lo, ms_hi=ms_hi, ms_lo_trials=lo, ms_hi_trials=hi)


def _clock_under_load(x) -> dict:
    """The SM clock and power draw read while the card runs the uncontracted
    map, and that load's own rate. ``under_load`` says whether the reading
    finished before the load did."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(LOAD_LAUNCHES):
        quad_map(x, LOAD_ITERS)
    end.record()
    time.sleep(0.2)
    clock, max_clock, draw = nvidia_smi("clocks.sm,clocks.max.sm,power.draw",
                                        x.device.index)
    under_load = not end.query()
    end.synchronize()
    ms = start.elapsed_time(end)
    ops = OPS_PER_ITER * x.numel() * LOAD_ITERS * LOAD_LAUNCHES
    return dict(sm_clock=clock, max_sm_clock=max_clock, power_draw=draw,
                under_load=under_load, load_ms=ms, load_ops_per_s=ops / (ms * 1e-3))


def fp32_rate(device=None) -> dict:
    """Measure the card's float32 rate with ``quad_map`` on a (512, 1024)
    block (inputs uniform in [-1, 1.6] from a fixed seed).

    Returns, for ``"uncontracted"`` and ``"contracted"``: ``ops_per_s`` (2
    operations per element per iteration, from the slope between L_LO and
    L_HI), ``overhead_us`` (per launch) and the median ms per launch at each
    count; ``"clock"``: the SM clock, its maximum and the power draw read
    under load; ``"card"`` and ``"power_limit"`` from ``nvidia-smi``.
    Raises when there is no CUDA card: a rate measured anywhere else is not
    the card's.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("fp32_rate measures a CUDA card, and none is available")
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"fp32_rate measures a CUDA card, got device {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(SHAPE, generator=gen, device=dev) * 2.6 - 1.0
    with torch.cuda.device(dev):
        out = {name: _rate(x, contract)
               for name, contract in (("uncontracted", False), ("contracted", True))}
        out["clock"] = _clock_under_load(x)
    card, limit = nvidia_smi("name,power.limit", dev.index)
    out.update(card=card, power_limit=limit, shape=SHAPE, l_lo=L_LO, l_hi=L_HI,
               reps=REPS, trials=TRIALS)
    return out
