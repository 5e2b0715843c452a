#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dmesh2_renderer_tpu_torch) on one NVIDIA card.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. Build every CUDA kernel from ``dmesh2_renderer_tpu_torch/csrc`` (one nvcc
   per source, all at once) and print the card's name and power limit, the
   ptxas resource lines and each kernel's registers, shared memory, spill
   and resident blocks per SM (the peel's for its 8-slot instance and for
   its wide and deep instances).
1b. The float32 rate calibration (``utils/fp32_rate.py``, the counterpart of
   ``benchmarks/micro_vpu.py``): ``quad_map``'s uncontracted instance equal
   to its plain version bit for bit on a seeded (512, 1024) block at L = 1,
   64 and 2048; its contracted instance within 1 ulp of a - x^2 computed in
   float64 and rounded once at L = 1; both inside [a - a^2, a] within 4 ulp
   at L = 1, 64, 2048 and 16384. Then ``fp32_rate``, with the launch count
   set to 0 just before and read just after (its launches are this path's):
   both instances' float32 rates from the slope between L = 2048 and 16384
   (neither may exceed 105% of the data-sheet 67e12) and launch overheads,
   the SM clock read under load, the card's name and power limit; the
   kernel's time at L = 2048 beside its bound and its plain version's.
2. Hold each kernel against its plain PyTorch version on the card, on the
   inputs the entry points give it (recorded as they call the kernel
   wrappers): icosphere(3), 4 views at 512x512 through one ragged 376x312
   window, tau 1 and 0. ``pack_stream`` must equal its plain version
   exactly; ``composite_fwd`` too, bit for bit (colour, depth, final_t,
   prev_t, n_contrib, nc_tile); ``composite_bwd`` (from ``loss.backward()``
   through ``render_partial``, with a loss on colour, depth and final_t)
   must agree column by column within 2e-5 x max(|column|, 1) on colour,
   opacity, intensity and z and 5e-4 x max(|column|, 1) on the
   Moeller-Trumbore and AA columns. The whole Renderer on the card is also
   held against the plain reference compositor (``use_pallas=False``) on a
   small scene: images, and the gradients autograd takes through it.
2b. The peel kernel against its plain version (layers and counts exactly
   equal) on the inputs ``LayeredRenderer.generate`` gives it: the JAX
   package's layered benchmark config (tet_grid(6), 512x512, 8 layers) and
   tet_grid(2) with a third of the faces deleted, 2 views, a ragged 100x84
   frame, 3 and 8 layers; there the card's LayeredRenderer is also held
   against the numpy brute force of tests/test_peel.py (under 1% of pixels
   may differ).
2d. The peel kernel against its plain version (layers and counts exactly
   equal on every tile) on an adversarial scene: tet_grid(12) seen from two
   eyes inside the grid (one on three grid planes, so faces there are
   edge-on and rays graze the planes beside them) and one outside eye on two
   grid planes looking along them, through a ragged 333x201 frame, at 1, 8,
   16, 17, 24, 31, 32, 33, 64, 96, 97 and 128 layers (17 to 96 run the wide
   instance, whose store walk changes form around 32 layers, 38,208 pixels
   there have more than 16 layers; 97 and 128 the deep one; the pixels past
   each one's shared-memory tiers are printed), and at 16 and 17 (the
   largest register instance and the smallest wide one, where the skip rule
   still drops pairs) with the rays scaled by 2 (longer than the skip bound
   assumes: those pixels skip nothing) and by 0.5. The plain version's
   counts of the pairs the kernel's skip rule drops and of the hits its
   insertion gate keeps out are printed. First a tie scene of three
   128-entry blocks at 3, 16, 17, 32 and 97 layers: its layers must be
   [257, 130, 5] (a tie across blocks, then a displaced slot carried past
   its tie). Then, above 16 layers (the tiered instances): their
   branch-free reciprocal must equal 1.0f / x on every float of its range
   (all 2^32 bit patterns tried); a stack of 150 sheets
   (utils/meshes.sheet_stack, three listed twice: exact t ties, some across
   128-entry blocks) seen head-on through 640x480 at 17, 32, 64, 96, 97 and
   128 layers: every tile equal, counts = L on every pixel (all past the
   slot tier), block lists past the list tier, and 2,400 half-tile units,
   more than either instance's persistent blocks, so each block loops over
   units; and the same with sheets of half size 1.5, whose edges cross the
   frame, so that counts fall from L to 0 and warps hold pixels on both
   sides of the slot tier.
2c. Both compositors against their plain versions on a synthetic stress
   scene (2 views x 1,000 small faces piled over a few tiles of a ragged
   72x40 window; bbox edges on pixel boundaries; entries no pixel blends
   between ones that do; prefixes that are not a multiple of the chunk or
   of the backward's entry group) at tau 0, 0.5 and 1: the forward bit for
   bit, the backward within the phase-2 tolerances and with identical bits
   on two runs.
2e. The binning's emission grid (``csrc/bin_emit.cu``) against its plain
   version (``emission_keys_plain``) on the card, bit for bit: keys,
   payloads, the three counts, the bit split and ``giant_ids``, then the
   whole ``Binning`` of ``bin_faces`` (the kernel's against the plain
   version's). Inputs: the binning arguments that ``Renderer.forward`` and
   ``LayeredRenderer.generate`` pass on the benchmark's two scenes at full
   size (``bench_port/configs``: the 1M-triangle soup at 1080p on three
   seeds, with the cull and 88-tile giant rows; tet_grid(32) in 2 views,
   32-tile giant rows, no cull), the four cases of
   ``tests/test_torch_binning.py`` (rect only, cull + giant, giant
   overflow, capacity overflow), a 2x2-tile grid whose keys keep 28 depth
   bits with depths at exactly 0 and 1, and screen triangles leaving a
   ragged frame on every side, one patch off the origin. Then each
   launch's device time (torch.profiler) beside its byte bound (keys and
   payloads written, faces read), and ``emission_keys`` and ``bin_faces``
   timed against their plain versions.
2f. The gradient reduction (``csrc/grad_reduce.cu``) against the plain
   reductions on the card, on the arguments the backward passes it in one
   training step (``Renderer.forward`` and ``loss.backward()`` of ``color.sum()
   + depth.sum()``) on the benchmark's soup at 1080p, one view and 16
   (``bench_port/configs``): ``reduce_entry_grads`` against
   ``reduce_entry_grads_plain`` and against ``contributing_mask`` +
   ``scatter_entry_grads``, and the AA corners' backward against
   ``aa_cotangent_to_verts_image_plain`` (``index_add_``). Each output
   element may differ by 2 (n - 1) u S, with u = 2^-24, n the most terms
   any element sums and S the element's sum of absolute terms: the bound of
   any two orders of a float32 sum. Then each one's device time beside its
   byte bound, the plain versions', the chain the kernel replaced (mask,
   sync, gather, ``index_add_``) and autograd's backward of the corner gather.
3. The main path at full size: one training step, ``Renderer.forward`` on
   the 1M-triangle soup at 1920x1080 (the JAX package's headline scene) and
   ``loss.backward()`` of ``color.sum() + depth.sum()``, with every kernel
   launch count set to 0 just before and read just after; every kernel must
   have launched. The output must be finite, drop no entries and cover
   pixels, and every gradient must be finite and non-zero. The kernels'
   outputs of that step, and the forward kernels' of a 256x256 window of
   the same scene, are held against their plain versions as in phase 2,
   which also count the work those inputs need (printed), and
   ``composite_bwd`` run twice more on the step's inputs must give the same
   bits. Then 5 Adam steps toward a target rendered with perturbed colours must
   lower the loss.
4. Timing with CUDA events (median of repeated runs after warm-up): the
   1080p forward and training step, the backward alone, each kernel on the
   main path's own inputs beside its plain version and its bound (the
   compositors' from the work their plain versions count on those inputs),
   the ``index_select`` yardstick of the record pack, every stage of the
   forward (projection, depth/cull, binning and its sort, pack, composite)
   and of the backward (composite_bwd, the gradient reduction, the
   autograd tail through the projection and the AA corners).
5. The layered main path at full size: ``LayeredRenderer.generate`` on
   tet_grid(32) (399,360 faces, a seeded half existing), 2 views at
   1920x1080, 8 layers, with every launch count set to 0 just before and
   read just after; the peel must have launched, nothing may be truncated,
   ``counts.max()`` must be 8 and every layer id -1 or an existing face.
   ``pack_stream``'s whole (R, 32) table, sentinel tail included, must equal
   its plain version (phase 3).
   72 sampled pixels must equal the numpy brute force on the port's own
   rays (except at an exact t tie) with non-decreasing t along the layers,
   and the kernel must equal its plain version on every 63rd tile, also
   when run on those tiles alone.
6. Layered timing: ``generate`` and Mpix/s, its stages (projection, min
   depth, binning, peel), the peel kernel beside its two bounds (the full
   scan the JAX kernel does, and the work left after the kernel's skip
   rule; entries, pairs, hits, skipped pairs and gated hits counted by the
   plain version over every tile in phase 5) and beside its plain version,
   over every tile and on the sampled tiles.
6b. ``parallel.generate_layers_sharded`` on a world of one, on the layered
   headline at 32 layers: equal bit for bit to ``functional.generate_layers``
   (the wide instance must launch), the kernel equal to its plain version
   on the sampled tiles; its time beside the full-scan bound (the same as
   at 8 layers: the bound does not depend on L), the kernel's and the plain
   version's times on the sampled tiles beside those tiles' after-skip
   bound at 32 layers, and its resources (it must not spill). Then the wide
   instance built with the deep instance's tiers at 17, 24, 32, 64 and 96
   layers, and with the other tiers of
   ``Sizes.wide_tier_sweep`` at 32 and 64, each equal to the package's
   kernel and timed on the same inputs. Then the same at 128 layers
   (the deep instance must launch): its first 32 layers and counts equal
   the 32-layer peel's on every pixel, all 128 equal the plain version's on
   the sampled tiles; the shares of pixels whose counts pass 16, 32, 48, 64,
   the slot tier and 96, the shares of (pixel, 128-entry block) lists
   longer than 8, 16, the list tier, 32 and 48 (from the plain version's
   histogram over every tile in phase 5), and the wide instance at 96
   layers and the deep one at 97 on the same inputs (continuity: the first
   96 layers must be equal, the times are printed side by side); its time
   beside the bound, and its resources
   (registers, static and dynamic shared memory, spill, blocks per SM, grid,
   scratch bytes): it must not spill and must hold 2 blocks per SM. Last,
   the deep instance built with the larger tiers of
   ``Sizes.deep_tier_sweep`` (a copy of csrc/peel.cu under the build
   directory), each equal to the package's kernel and timed on the same
   inputs, with its resident blocks per SM.
6c. ``train.Trainer`` at the JAX package's BASELINE.json config 5
   (icosphere(3), 64 orbit views at 256x256, Adam 1e-2, binning capacity
   2^20) on a world of one: 2 warm-up steps, then timed steps (CUDA events;
   ms per step and steps/s printed with the card); the loss must fall, the
   three renderer kernels must launch, their outputs in the first step must
   agree with their plain versions on the same inputs (as in phase 2), and
   a checkpoint saved and restored
   under a temporary directory must give the step, the parameters and
   Adam's state back exactly.
6d. ``suggest_config`` on the 1M-triangle 1080p headline scene; a render with
   the suggested config must truncate nothing.
6e. ``utils.profiling.profile_render`` on the headline scene: its six stages,
   the end-to-end forward and step, and the unattributed remainder.
6f. Face slabs: the headline as 4 depth slabs, the per-rank body of
   ``parallel/face_parallel.py`` for each in one process (a card hosts one
   rank), folded front to back. The three kernels of the last slab's
   forward and backward in one slab training step against their plain
   versions (as in phase 2). The fold against ``functional.render`` with
   the faces renumbered in depth order and no giant tier or exact tile
   cull, where the two composite every pixel's faces in one order: within
   2e-5 where one render does not stop early, and within 2e-5 + its final T
   where it does (each slab stops on its own T). With the headline as it
   is, the fold departs from the render where faces' quantized depths tie,
   as the JAX package's slabs do: the pixels beyond that bound are counted
   and held to ``Sizes.slab_tie_share`` of the frame and
   ``tie_departure_max``. ``render_faces_sharded`` on a world of one
   (faces in depth order) within 2e-5 of ``render``; the 4-slab forward and
   training step beside one render's; on config 5's scene (4 views) the
   slabs' gradients, summed as the all-reduce would, against autograd of
   the unsharded loss within 5e-5 x scale + 1e-7.
6g. Pixel bands: the headline as 4 bands of 270 rows, the per-rank body of
   ``parallel/patch_parallel.py`` for each in one process, stitched. The
   two forward kernels of band 1 (origin y0 = 270, off the tile grid)
   against their plain versions. The stitch against ``functional.render``
   with the faces renumbered in depth order and no giant tier or exact
   tile cull: within 1e-6 (bit-identity printed); with the headline as it
   is, the pixels departing by more than 1e-6 held to
   ``Sizes.band_tie_share`` and ``tie_departure_max``.
   ``render_pixels_sharded`` on a world of one equal to ``render``; the
   4-band forward beside one render's.
6h. ``train.Trainer`` on a (1, 1) ("dp", "sp") mesh at config 5 (the grid
   step): the three kernels launch, and in the first step agree with their
   plain versions, the loss falls, ms per step; a (2, 2) grid's four (view
   half, band) bodies in one process, averaged, against
   ``make_sharded_train_step`` on a world of one (loss within 1e-5
   relative, gradients within 1e-6 x max(|g|, 1)), and the kernels of its
   last body (32 views, rows 128-255) against their plain versions.
6i. The port's fitting example (``python -m
   dmesh2_renderer_tpu_torch.examples.fit_mesh``) at its defaults (128x128,
   16 views) for 60 steps with a temporary checkpoint: the three renderer
   kernels launch, the loss falls, nothing is truncated, ms per step; run
   again for 10 steps it starts at step 60, its first two losses agree
   within 1e-5 relative with two steps continued in-process from the first
   run's state (the second after an Adam update from the restored
   moments), its Adam step count goes on from 60, and the kernels of its
   last step are held against their plain versions at the example's
   inputs and tile budget.
7. The card's busy time in the 1080p forward and training step and in the
   4-slab and 4-band forwards: the union of the device intervals
   torch.profiler records, beside the wall time of the profiled calls.

After the phases, each operation-bound kernel's time is printed beside
its bound at the two measured float32 rates of phase 1b
(``bound_ms_uncontracted``, ``bound_ms_contracted``).

The next-to-last lines are the ``{"kernels": [...]}`` JSON line (each
kernel's ``launches`` summed over the main-path runs: the 1080p training
step, the layered generate, the sharded peels, the Trainer's warm-up
steps, the slab forward and training step, the band forwards, the grid
Trainer's warm-up steps and the fitting example's first run; ``quad_map``'s
from the calibration, timed at L = 2048 uncontracted; ``peel`` is the register instances, 1 to 16
slots, timed at 8, ``peel_wide`` the wide instance, timed at 32, whose
``plain_ms`` is taken on the sampled tiles named in ``plain_tiles``, beside
the kernel's ``ms_plain_tiles`` there and those tiles' after-skip bound
``bound_ms_after_skip_plain_tiles``, and ``peel_deep`` the deep
instance, timed at 128, whose ``plain_ms`` is taken on the sheet stack
named in ``plain_inputs``, beside the kernel's ``ms_plain_inputs`` there)
and the card's ``nvidia-smi`` name and power
limit; the last line is the ``{"ok": true, "device": {...}}`` JSON line.
Each phase ends with its seconds on the host clock. A full report is also
written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# throughput outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# The TPU kernel each CUDA kernel replaces (file:line of the Pallas kernel).
REPLACES = {
    "pack_stream": "dmesh2_renderer_tpu/ops/binning.py:58",
    "composite_fwd": "dmesh2_renderer_tpu/ops/pallas_fwd.py:254",
    "composite_bwd": "dmesh2_renderer_tpu/ops/pallas_bwd.py:62",
    "peel": "dmesh2_renderer_tpu/ops/peel.py:84",
    "peel_wide": "dmesh2_renderer_tpu/ops/peel.py:84",
    "peel_deep": "dmesh2_renderer_tpu/ops/peel.py:84",
    "quad_map": "benchmarks/micro_vpu.py:34",
    # No Pallas kernel: the JAX package's emission grid is XLA ops.
    "bin_emit": "dmesh2_renderer_tpu/ops/binning.py:184",
    # No Pallas kernels: XLA sorts and segmented scans.
    "grad_reduce": "dmesh2_renderer_tpu/ops/pallas_bwd.py:546",
    "corner_reduce": "dmesh2_renderer_tpu/geometry.py:253",
}
# The kernels of each main path: the training step (and the sharded ones),
# a forward, the layered peel at 8 layers (the register instances) and the
# sharded peel at 32 (the wide one) and 128 (the deep one).
TRAINING_KERNELS = ("bin_emit", "pack_stream", "composite_fwd", "composite_bwd",
                    "grad_reduce", "corner_reduce")
FORWARD_KERNELS = ("bin_emit", "pack_stream", "composite_fwd")
LAYERED_KERNELS = ("bin_emit", "peel")
SHARDED_KERNELS = ("bin_emit", "peel_wide")
DEEP_KERNELS = ("bin_emit", "peel_deep")
CALIBRATION_KERNELS = ("quad_map",)

# composite_bwd vs its plain version, per gradient-record column, times
# max(|column|, 1): the kernel's block sums and the plain version's
# torch.sum associate differently, and the Moeller-Trumbore and AA columns
# come out of epilogues that cancel (the tolerances of
# tests/test_pallas_bwd.py:97-102).
BWD_COLUMNS = [(9, 18, "verts_color", 2e-5), (18, 19, "opacity", 2e-5),
               (19, 20, "intensity", 2e-5), (20, 23, "z", 2e-5),
               (0, 9, "verts", 5e-4), (23, 29, "aa", 5e-4)]
TRAINABLE = ("verts", "verts_color", "faces_opacity", "faces_intense")


@dataclasses.dataclass
class Sizes:
    """Scene sizes; the defaults are what ``python3 chip_smoke.py`` runs."""

    check_subdiv: int = 3
    check_views: int = 4
    check_res: int = 512
    check_window: tuple = (70, 90, 376, 312)        # x0, y0, pw, ph (ragged)
    small_subdiv: int = 2
    small_res: int = 128
    # Compositor stress scene: per view, stress_faces small faces piled over
    # three clusters of a few tiles in a ragged window.
    stress_views: int = 2
    stress_faces: int = 1000
    stress_window: tuple = (72, 40)                 # pw, ph (ragged)
    stress_taus: tuple = (0.0, 0.5, 1.0)
    stress_seed: int = 4
    n_faces: int = 1_000_000
    width: int = 1920
    height: int = 1080
    patch: tuple = (832, 412, 256, 256)             # x0, y0, pw, ph
    capacity: int = 32 * (1 << 17)
    reps: int = 10
    plain_reps: int = 1
    adam_steps: int = 5
    # Layered path. Check scenes: the JAX package's layered benchmark
    # config (benchmarks/run.py config 3, whose default max_tiles_per_face
    # truncates a few entries, in the JAX package too) and a small ragged
    # scene with a third of the faces deleted, also held against the numpy
    # brute force.
    peel_res: int = 6
    peel_hw: int = 512
    peel_capacity: int = 1 << 19
    peel_small_frame: tuple = (100, 84)             # width, height (ragged)
    peel_small_layers: tuple = (3, 8)
    # Main layered path: tet_grid(32) (35,937 vertices, 399,360 faces), two
    # views at width x height, 8 layers, binning sized so nothing is cut.
    layered_res: int = 32
    layered_views: int = 2
    layered_layers: int = 8
    layered_capacity: int = 9 << 20
    layered_max_tiles: int = 32
    layered_giant_faces: int = 8192
    layered_giant_tiles: int = 32
    layered_exist_frac: float = 0.5
    layered_tile_stride: int = 63                   # every 63rd tile: >= 256 of 16,320
    layered_pixels: int = 64
    # Adversarial peel scene (phase 2d): tet_grid(adv_res), whose grid
    # planes lie at multiples of 2.4 / adv_res from -1.2, three views.
    adv_res: int = 12
    adv_frame: tuple = (333, 201)                   # width, height (ragged)
    adv_layers: tuple = (1, 8, 16, 17, 24, 31, 32, 33, 64, 96, 97, 128)
    adv_capacity: int = 1 << 21
    adv_ray_scales: tuple = (2.0, 0.5)
    adv_ray_layers: tuple = (16, 17)
    # Above 16 layers (the tiered instances): utils/meshes.sheet_stack, 150
    # sheets of two triangles (three listed twice: exact t ties, some across
    # 128-entry blocks) seen head-on through a deep_frame window, every ray
    # crossing all of them; at deep_layers layers (the wide instance up to
    # 96, the deep one above). 1,200 tiles: 2,400 half-tile units, more than
    # the persistent grid's blocks, so blocks loop and reuse their scratch.
    deep_frame: tuple = (640, 480)                  # width, height
    deep_half_size: float = 5.0
    # Sheets whose edges cross the frame: about 57 to 153 hits per ray.
    deep_ring_half_size: float = 1.5
    deep_layers: tuple = (17, 32, 64, 96, 97, 128)
    deep_capacity: int = 1 << 19
    # Tiles the plain peel takes at once on the card: its time is mostly
    # the launches of its L x L merge, one set per group.
    plain_peel_group: int = 1024
    # Phase 6b: the sharded peel on the layered headline, above 16 layers
    # (the wide instance) and above 96 (the deep one).
    sharded_layers: int = 32
    sharded_deep_layers: int = 128
    # ... and the deep instance built with these other (slot, list) tiers:
    # the one that holds 95% of the headline's pixels (2 blocks per SM), two
    # between it and the package's, and the wide instance's.
    deep_tier_sweep: tuple = ((80, 24), (48, 18), (32, 15), (8, 8))
    # The wide instance: built with the deep instance's tiers at
    # deep_tier_layers, and with these other (slot, list) tiers at
    # wide_sweep_layers, each on the layered headline's inputs.
    deep_tier_layers: tuple = (17, 24, 32, 64, 96)
    wide_tier_sweep: tuple = ((4, 4), (8, 4), (16, 4), (16, 8), (32, 8))
    wide_sweep_layers: tuple = (32, 64)
    # Phase 6c: the Trainer at the JAX package's BASELINE.json config 5.
    trainer_subdiv: int = 3
    trainer_views: int = 64
    trainer_res: int = 256
    trainer_capacity: int = 1 << 20
    trainer_steps: int = 8
    profile_iters: int = 5
    # Phases 6f-6h: the headline as this many face slabs and pixel bands
    # (one process running every rank's body); the slabs' gradients checked
    # on config 5's scene at slab_grad_views views.
    slabs: int = 4
    bands: int = 4
    slab_grad_views: int = 4
    # Phases 6f and 6g compare the sharded frames with one render on the
    # headline renumbered in depth order under a config where every face's
    # tiles are in the regular tier and none is culled (the capacity holds
    # the uncull rectangles): there they must agree. With the headline as
    # it is, they depart where faces' quantized depths tie, as the JAX
    # package's do: on at most these shares of the pixels, by at most this.
    # Each is twice what the H100 showed (0.99% and 2.54% of the pixels, by
    # up to 0.233).
    tie_free_kt: int = 64
    tie_free_capacity: int = 8 << 20
    slab_tie_share: float = 0.02
    band_tie_share: float = 0.05
    tie_departure_max: float = 0.5
    # Phase 1b: the float32 rate calibration's kernel against its plain
    # version at these iteration counts (the largest is fp32_rate's L_LO).
    quad_map_iters: tuple = (1, 64, 2048)
    # Phase 6i: the fitting example at its defaults for fit_steps steps,
    # then resumed for fit_resume_steps.
    fit_steps: int = 60
    fit_resume_steps: int = 10
    # Phase 2e: the benchmark's soup drawn from these seeds (the tet grid's
    # binning is the same for every seed: it bins every face), and the
    # launches timed per scene.
    bin_seeds: tuple = (1, 2718281828, 3141592653)
    bin_reps: int = 20
    # Phase 2f: the benchmark's soup configurations whose training step
    # feeds the gradient reduction, at this seed.
    reduce_configs: tuple = ("soup1m_1080p", "soup1m_16view_1080p")
    reduce_seed: int = 1618033988


def nvidia_smi_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    from dmesh2_renderer_tpu_torch.utils.fp32_rate import nvidia_smi

    return ", ".join(nvidia_smi("name,power.limit", torch.cuda.current_device()))


def sync():
    torch.cuda.synchronize()


def time_ms(fn, reps: int, warmup: int = 1) -> tuple[float, list[float]]:
    """Median milliseconds of ``fn()`` over ``reps`` runs, each timed with
    CUDA events around one call, after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def queued_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn()``: ``reps`` calls queued behind
    a spin kernel (``torch.cuda._sleep``, ~10 ms), so that the card runs
    them back to back between two events and the host's time to launch
    them drops out; after one warm-up call."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """Milliseconds of one call of ``fn()`` (CUDA events), and its result."""
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def merged_span_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            total += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def device_busy(fn, reps: int = 3) -> tuple[float, float]:
    """Wall milliseconds per call of ``fn()`` (CUDA events around ``reps``
    calls, after one warm-up) under torch.profiler, and the milliseconds per
    call in which the card ran a kernel or a copy: the union of the device
    activity intervals the profiler records. The profiler slows the host,
    so their ratio is a lower bound of the device's busy share. Busy is 0
    when the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return start.elapsed_time(end) / reps, merged_span_us(spans) / 1e3 / reps


def scene_tensors(verts, faces, b, rng, dev):
    """Random colours, opacities and intensities from ``rng``, on ``dev``."""
    f = faces.shape[0]
    return dict(
        verts=torch.as_tensor(verts, device=dev),
        faces=torch.as_tensor(faces, dtype=torch.int32, device=dev),
        verts_color=torch.as_tensor(
            rng.uniform(size=verts.shape).astype(np.float32), device=dev),
        faces_opacity=torch.as_tensor(
            rng.uniform(0.3, 1.0, size=(f,)).astype(np.float32), device=dev),
        faces_intense=torch.as_tensor(
            rng.uniform(0.5, 1.0, size=(b, f)).astype(np.float32), device=dev),
        background=torch.tensor([0.1, 0.2, 0.3], device=dev),
    )


def scene_args(s):
    """``Renderer.forward``'s scene arguments, in its order."""
    return (s["verts"], s["faces"], s["verts_color"], s["faces_opacity"],
            s["faces_intense"], s["background"])


@contextlib.contextmanager
def captured_kernel_calls(module=None, names=("pack_stream", "composite_forward",
                                              "composite_backward"), copy=False):
    """Record the arguments and the result of each kernel wrapper as the
    main path calls it (by default ``pack_stream``, ``composite_forward``
    and ``composite_backward``, looked up in ``ops/rasterize.py``; the
    layered path's ``peel_layers`` is looked up in ``functional.py``), so
    that the checks and the timings run on exactly what the main path fed
    the kernels.

    Yields a dict: wrapper name -> (positional args, result) of its last call.
    With ``copy`` the tensors are copies, kept from later in-place updates
    (an optimizer's step on the parameters).
    """
    if module is None:
        from dmesh2_renderer_tpu_torch.ops import rasterize as module

    calls = {}
    originals = {name: getattr(module, name) for name in names}

    def detached(xs):
        return tuple((x.detach().clone() if copy else x.detach())
                     if isinstance(x, torch.Tensor) else x for x in xs)

    def recording(name, fn):
        def call(*args):
            out = fn(*args)
            calls[name] = (detached(args), detached(out) if isinstance(out, tuple)
                           else out.detach())
            return out
        return call

    for name, fn in originals.items():
        setattr(module, name, recording(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def compare_composite(kernel_out, plain_out, label):
    """composite_fwd must equal its plain version bit for bit: colour,
    depth, final_t, prev_t, n_contrib and nc_tile (the backward replays its
    blend decisions). Prints the max abs errors and count mismatches; raises
    unless all are zero."""
    errs = {}
    for name, k, p in zip(("color", "depth", "final_t", "prev_t"),
                          kernel_out[:4], plain_out[:4]):
        if not torch.isfinite(k).all():
            raise AssertionError(f"{label}: composite_fwd {name} not finite")
        errs[name] = float((k - p).abs().max()) if k.numel() else 0.0
    nc_bad = int((kernel_out[4] != plain_out[4]).sum())
    tile_bad = int((kernel_out[5] != plain_out[5]).sum())
    n_pix, n_tiles = kernel_out[4].numel(), kernel_out[5].numel()
    print(f"  {label}: composite_fwd max|err| " +
          " ".join(f"{k}={v:.3g}" for k, v in errs.items()) +
          f"; n_contrib mismatches {nc_bad}/{n_pix}, nc_tile {tile_bad}/{n_tiles}")
    if not all(torch.equal(k, p) for k, p in zip(kernel_out, plain_out)):
        raise AssertionError(f"{label}: composite_fwd differs from its plain version")
    return max(errs.values())


def compare_pack(kernel_rec, plain_rec, label, tail):
    """The whole (R, 32) table must equal the plain version's, the ``tail``
    sentinel rows included."""
    if not torch.equal(kernel_rec, plain_rec):
        err = float((kernel_rec - plain_rec).abs().max())
        raise AssertionError(f"{label}: pack_stream differs from plain, max {err}")
    print(f"  {label}: pack_stream equals its plain version on all "
          f"{kernel_rec.shape[0]} records ({tail} of them the sentinel tail)")
    return 0.0


def check_kernels(calls, label, report, work=None):
    """Hold each kernel's output from one main-path call (``calls`` from
    :func:`captured_kernel_calls`) against its plain version on the same
    inputs. Returns the plain compositor's output; ``work`` is passed on to
    it to count the compositing work of these inputs."""
    from dmesh2_renderer_tpu_torch.ops.binning import pack_stream_plain
    from dmesh2_renderer_tpu_torch.ops.composite_fwd import composite_forward_plain

    pack_args, records = calls["pack_stream"]
    tail = int((pack_args[0] == pack_args[6].numel()).sum())
    err = compare_pack(records, pack_stream_plain(*pack_args), label, tail)
    report["pack_stream"]["max_abs_err"] = max(report["pack_stream"]["max_abs_err"], err)
    comp_args, out = calls["composite_forward"]
    plain = composite_forward_plain(*comp_args, work=work)
    sync()
    err = compare_composite(out, plain, f"{label} tau={comp_args[-1]}")
    report["composite_fwd"]["max_abs_err"] = max(report["composite_fwd"]["max_abs_err"], err)
    return plain


def compare_backward(kernel_rec, plain_rec, label):
    """Column-group errors of composite_bwd vs its plain version, each
    against its tolerance (``BWD_COLUMNS``); raises when one exceeds it.
    Returns the largest absolute error."""
    if not torch.isfinite(kernel_rec).all():
        raise AssertionError(f"{label}: composite_bwd records not finite")
    worst, msgs = 0.0, []
    for lo, hi, name, tol in BWD_COLUMNS:
        k, p = kernel_rec[:, lo:hi], plain_rec[:, lo:hi]
        err = float((k - p).abs().max()) if k.numel() else 0.0
        scale = max(float(p.abs().max()) if p.numel() else 0.0, 1.0)
        worst = max(worst, err)
        msgs.append(f"{name}={err:.3g}/{scale:.3g}")
        if err > tol * scale:
            raise AssertionError(f"{label}: composite_bwd {name} error {err} > "
                                 f"{tol} x {scale}")
    pad = float(kernel_rec[:, 29:].abs().max()) if kernel_rec.numel() else 0.0
    if pad != 0.0:
        raise AssertionError(f"{label}: composite_bwd padding columns not zero")
    print(f"  {label}: composite_bwd max|err|/scale " + " ".join(msgs) +
          f" ({int((kernel_rec != 0).any(dim=1).sum())} non-zero of "
          f"{kernel_rec.shape[0]} rows)")
    return worst


def in_prefixes(bwd_args, table):
    """The backward compositor's table with every row outside the
    contributing prefixes zeroed: ``composite_backward`` leaves those rows
    unset on the card, and nothing reads them."""
    from dmesh2_renderer_tpu_torch.ops.binning import contributing_mask

    keep, _ = contributing_mask(bwd_args[1], bwd_args[2], bwd_args[3], table.shape[0])
    return torch.where(keep[:, None], table, 0.0)


def check_tally(args, out, work, label):
    """composite_bwd again on ``args`` with a tally: the same bits as ``out``
    (its table, rows outside the prefixes zeroed), and its queued pairs,
    gradient batches and butterflies equal to the plain version's
    ``blend_pairs`` and ``grad_batches`` (``work``; one butterfly a batch).
    Prints the gradient pass's lane occupancy, pairs / (32 x batches),
    beside one thread per pixel's, pairs / (32 x blend_warp_entries)."""
    from dmesh2_renderer_tpu_torch.ops.composite_bwd import composite_backward

    tally = torch.zeros(3, dtype=torch.int64, device=args[0].device)
    again = in_prefixes(args, composite_backward(*args, tally=tally))
    got = tally.tolist()
    want = [int(work[k]) for k in ("blend_pairs", "grad_batches", "grad_batches")]
    warps = int(work["blend_warp_entries"])
    lanes = want[0] / (32 * want[1]) if want[1] else 0.0
    per_pixel = want[0] / (32 * warps) if warps else 0.0
    print(f"    {label}: composite_bwd queued {got[0]} pairs in {got[1]} batches, "
          f"{got[2]} butterflies (plain: blend_pairs {want[0]}, grad_batches {want[1]}); "
          f"lane occupancy {100 * lanes:.1f}% (one thread per pixel {100 * per_pixel:.1f}% "
          f"over {warps} warp entries)")
    if got != want:
        raise AssertionError(f"{label}: composite_bwd tally {got} != plain {want}")
    if not torch.equal(again, out):
        raise AssertionError(f"{label}: composite_bwd differs between two runs")


def check_backward(calls, label, report, work=None):
    """Hold composite_bwd's output from one backward (``calls`` from
    :func:`captured_kernel_calls`) against its plain version on the same
    inputs, on the rows of the contributing prefixes, then its tally
    (:func:`check_tally`); ``work`` is passed on to count the work of these
    inputs."""
    from dmesh2_renderer_tpu_torch.ops.composite_bwd import composite_backward_plain

    args, out = calls["composite_backward"]
    out = in_prefixes(args, out)
    work = {} if work is None else work
    plain = composite_backward_plain(*args, work=work)
    sync()
    label = f"{label} tau={args[-1]}"
    err = compare_backward(out, plain, label)
    report["composite_bwd"]["max_abs_err"] = max(report["composite_bwd"]["max_abs_err"], err)
    check_tally(args, out, work, label)
    return plain


def leaves_of(s):
    """Trainable leaf copies of a scene's parameters."""
    return {k: s[k].detach().clone().requires_grad_(True) for k in TRAINABLE}


def phase_kernel_checks(dev, sz: Sizes, report):
    from dmesh2_renderer_tpu_torch import RasterConfig, Renderer, render_partial
    from dmesh2_renderer_tpu_torch.utils.meshes import icosphere, orbit_cameras

    print(f"phase 2: kernels vs plain versions, icosphere({sz.check_subdiv}), "
          f"{sz.check_views} views, {sz.check_res}^2, window {sz.check_window}")
    rng = np.random.default_rng(0)
    verts, faces = icosphere(sz.check_subdiv)
    mv, proj = orbit_cameras(sz.check_views)
    s = scene_tensors(verts, faces, sz.check_views, rng, dev)
    x0, y0, pw, ph = sz.check_window
    config = RasterConfig(binning_capacity=1 << 16)
    renderer = Renderer(mv, proj, sz.check_res, sz.check_res, config=config)
    for tau in (1.0, 0.0):
        with captured_kernel_calls() as calls:
            renderer.forward(list(range(sz.check_views)), [[x0, y0]] * sz.check_views,
                             pw, ph, *scene_args(s), aa_temperature=tau)
        if int(renderer.last_aux.num_truncated):
            raise AssertionError("phase 2 binning truncated entries")
        check_kernels(calls, "check", report)

    # The backward kernel, from loss.backward() through render_partial with
    # a loss on colour, depth and final_t (so g_final_t is not zero).
    v = sz.check_views
    weights = [torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev)
               for shape in ((v, ph, pw, 3), (v, ph, pw), (v, ph, pw))]
    for tau in (1.0, 0.0):
        p = leaves_of(s)
        with captured_kernel_calls() as calls:
            outs = render_partial(p["verts"], s["faces"], p["verts_color"],
                                  p["faces_opacity"], p["faces_intense"], mv, proj,
                                  s["background"], sz.check_res, sz.check_res, tau,
                                  config, patch_origin=(x0, y0), patch_shape=(ph, pw))
            sum((o * w).sum() for o, w in zip(outs[:3], weights)).backward()
        if int(outs[3].num_truncated):
            raise AssertionError("phase 2 binning truncated entries")
        check_backward(calls, "check", report)

    # The whole Renderer on the card vs the plain reference compositor:
    # images, and the gradients of a weighted loss on colour and depth.
    verts, faces = icosphere(sz.small_subdiv)
    # Off the icosphere's lattice: exact vertex-on-pixel-boundary ties are
    # subgradient choices where analytic and autodiff gradients may differ.
    verts = verts + np.random.default_rng(12345).normal(
        scale=1e-3, size=verts.shape).astype(np.float32)
    mv2, proj2 = orbit_cameras(2)
    s = scene_tensors(verts, faces, 2, rng, dev)
    res = sz.small_res
    pw2, ph2 = res - 24, res - 40
    w_c = torch.as_tensor(rng.normal(size=(2, ph2, pw2, 3)).astype(np.float32), device=dev)
    w_d = torch.as_tensor(rng.normal(size=(2, ph2, pw2)).astype(np.float32), device=dev)
    out, grads = {}, {}
    for use_pallas in (True, False):
        r = Renderer(mv2, proj2, res, res, config=RasterConfig(use_pallas=use_pallas))
        p = leaves_of(s)
        color, depth = r.forward([0, 1], [[0, 0], [8, 24]], pw2, ph2, p["verts"],
                                 s["faces"], p["verts_color"], p["faces_opacity"],
                                 p["faces_intense"], s["background"],
                                 aa_temperature=1.0)
        ((color * w_c).sum() + (depth * w_d).sum()).backward()
        out[use_pallas] = (color.detach(), depth.detach())
        grads[use_pallas] = {k: p[k].grad for k in TRAINABLE}
    err = max(float((a - b).abs().max()) for a, b in zip(out[True], out[False]))
    print(f"  Renderer (kernels) vs Renderer(use_pallas=False): max|err| {err:.3g}")
    if not err <= 2e-5:
        raise AssertionError(f"Renderer vs reference compositor: {err}")
    # Colour, opacity and intensity gradients are sums that reassociate
    # only: 2e-5 x scale. verts: 5e-4 x scale, the tolerance of the JAX
    # package's analytic-vs-autodiff test on a scene jittered off the
    # lattice, as this one is.
    msgs = []
    for k, tol in (("verts_color", 2e-5), ("faces_opacity", 2e-5),
                   ("faces_intense", 2e-5), ("verts", 5e-4)):
        a, b = grads[True][k], grads[False][k]
        e = float((a - b).abs().max())
        scale = max(float(b.abs().max()), 1.0)
        msgs.append(f"{k} {e:.3g}/{scale:.3g}")
        if not (torch.isfinite(a).all() and e <= tol * scale):
            raise AssertionError(f"backward vs reference autograd: {k} {e} > {tol} x {scale}")
    print("  backward (kernels) vs autograd of use_pallas=False: max|err|/scale "
          + ", ".join(msgs))


def stress_scene(dev, sz: Sizes):
    """Compositor inputs of a synthetic pile, made with numpy from
    ``sz.stress_seed``: per view, ``sz.stress_faces`` small faces (a few
    pixels across, opacity 0.02-0.25) around three cluster centres, seen by
    a pinhole camera through a ragged window, and four near-opaque quads
    over two whole tiles mid-pile (those tiles stop before the end of their
    lists, at tau 0). A quarter of the small faces have
    one bbox edge moved onto a pixel boundary (px0 + 1 == txmin, px0 ==
    txmax, and the same in y). Each tile lists, by depth, the faces whose
    bbox meets one of its pixel boxes, with one in eight as many faces far
    from the tile inserted at random places: entries no pixel can blend,
    between entries that do.

    Returns (composite_forward's arguments without tau, number of entries
    with a pixel box of their tile at px0 + 1 == txmin).
    """
    rng = np.random.default_rng(sz.stress_seed)
    b, (pw, ph) = sz.stress_views, sz.stress_window
    gx, gy = -(-pw // 16), -(-ph // 16)
    focal, cx, cy = 40.0, pw / 2 + 1.3, ph / 2 - 0.7
    patch_min = np.array([[3, 5], [0, 0]], np.int32)[:b]
    ray_o = np.array([[0.0, 0.0, 0.0], [0.2, -0.1, 0.05]], np.float32)[:b]
    xs = patch_min[:, 0, None, None] + np.arange(pw)[None, None, :] + 0.5
    ys = patch_min[:, 1, None, None] + np.arange(ph)[None, :, None] + 0.5
    d = np.stack(np.broadcast_arrays((xs - cx) / focal, (ys - cy) / focal,
                                     np.ones((b, ph, pw))), -1)
    ray_d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)

    recs, starts, counts, touch = [], [], [], 0
    n = sz.stress_faces
    for view in range(b):
        centres = patch_min[view] + rng.uniform([6, 6], [pw - 6, ph - 6], size=(3, 2))
        c = centres[rng.integers(0, 3, n)] + rng.normal(scale=4.0, size=(n, 2))
        aa = c[:, None, :] + rng.uniform(-3.0, 3.0, size=(n, 3, 2))
        for i in np.nonzero(rng.uniform(size=n) < 0.25)[0]:
            coords = aa[i, :, rng.integers(0, 2)]
            k = np.argmin(coords) if rng.uniform() < 0.5 else np.argmax(coords)
            coords[k] = np.round(coords[k])
        z = rng.uniform(2.0, 5.0, size=(n, 3))
        # Four near-opaque quads (faces 0-7) over two whole tiles, mid-pile:
        # those tiles stop before the end of their lists.
        x0, y0 = patch_min[view]
        a, b_, c_, d_ = np.array([[15, -1], [49, -1], [49, 17], [15, 17]]) + [x0, y0]
        for q in range(4):
            aa[2 * q], aa[2 * q + 1] = (a, b_, c_), (a, c_, d_)
            z[2 * q:2 * q + 2] = 3.0 + 0.2 * q
        # Counter-clockwise: positive shoelace area, as the AA area expects.
        x, y = aa[..., 0], aa[..., 1]
        area2 = (x[:, 0] * y[:, 1] - x[:, 1] * y[:, 0] + x[:, 1] * y[:, 2]
                 - x[:, 2] * y[:, 1] + x[:, 2] * y[:, 0] - x[:, 0] * y[:, 2])
        aa[area2 < 0] = aa[area2 < 0][:, [0, 2, 1]]
        aa = aa.astype(np.float32)
        verts = ray_o[view] + np.stack([(aa[..., 0] - cx) / focal * z,
                                        (aa[..., 1] - cy) / focal * z, z], -1)
        rec = np.zeros((n, 32), np.float32)
        rec[:, 0:9] = verts.reshape(n, 9)
        rec[:, 9:18] = rng.uniform(size=(n, 9))
        rec[:, 18] = rng.uniform(0.02, 0.25, n)
        rec[:8, 18] = 0.95
        rec[:, 19] = rng.uniform(0.5, 1.0, n)
        rec[:, 20:23] = z / 10.0
        rec[:, 23:29] = aa.reshape(n, 6)
        order = np.argsort(z.mean(1), kind="stable")
        txmin, txmax = aa[..., 0].min(1), aa[..., 0].max(1)
        tymin, tymax = aa[..., 1].min(1), aa[..., 1].max(1)
        for ty in range(gy):
            for tx in range(gx):
                x0, y0 = patch_min[view, 0] + 16 * tx, patch_min[view, 1] + 16 * ty
                x1, y1 = min(x0 + 16, patch_min[view, 0] + pw), min(y0 + 16, patch_min[view, 1] + ph)
                # A pixel box [px0, px0 + 1] of the tile meets the bbox.
                meets = (txmin <= x1) & (txmax >= x0) & (tymin <= y1) & (tymax >= y0)
                ids = order[meets[order]]
                far = np.nonzero((txmin > x1 + 2) | (txmax < x0 - 2)
                                 | (tymin > y1 + 2) | (tymax < y0 - 2))[0]
                k = min(len(far), max(1, len(ids) // 8))
                ids = np.insert(ids, np.sort(rng.integers(0, len(ids) + 1, k)),
                                rng.choice(far, k, replace=False))
                touch += int(((txmin[ids] > x0) & (txmin[ids] <= x1)
                              & (txmin[ids] == np.round(txmin[ids]))
                              & (tymin[ids] <= y1) & (tymax[ids] >= y0)).sum())
                starts.append(sum(len(r) for r in recs))
                counts.append(len(ids))
                recs.append(rec[ids])

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    args = (t(np.concatenate(recs)), t(np.asarray(starts), torch.int32),
            t(np.asarray(counts), torch.int32), t(ray_o), t(ray_d),
            torch.tensor([0.1, 0.2, 0.3], device=dev), t(patch_min), pw, ph)
    return args, touch


def phase_stress(dev, sz: Sizes, report):
    """Both compositors against their plain versions on the stress scene
    (:func:`stress_scene`) at each tau: the forward bit for bit, the
    backward within its per-column tolerances and with identical bits on
    two runs. The scene must give a contributing prefix longer than a chunk
    whose length is not a multiple of the chunk or of the backward's entry
    group, and entries no pixel blends between entries that do."""
    from dmesh2_renderer_tpu_torch.ops.composite_bwd import (
        composite_backward, composite_backward_plain)
    from dmesh2_renderer_tpu_torch.ops.composite_fwd import (
        composite_forward, composite_forward_plain)

    args, touch = stress_scene(dev, sz)
    records, starts, counts = args[:3]
    b, (pw, ph) = sz.stress_views, sz.stress_window
    print(f"phase 2c: compositor stress scene, {b} views x {sz.stress_faces} faces "
          f"piled in a ragged {pw}x{ph} window: {records.shape[0]} entries over "
          f"{counts.numel()} tiles (longest list {int(counts.max())}); {touch} "
          "entries with a pixel box at px0 + 1 == txmin")
    if touch == 0:
        raise AssertionError("stress scene has no bbox touching a pixel box")
    rng = np.random.default_rng(sz.stress_seed + 1)
    cot = [torch.as_tensor(rng.normal(size=s).astype(np.float32), device=dev)
           for s in ((b, ph, pw, 3), (b, ph, pw), (b, ph, pw))]
    ragged = idle = stopped = 0
    for tau in sz.stress_taus:
        out = composite_forward(*args, tau)
        err = compare_composite(out, composite_forward_plain(*args, tau),
                                f"stress tau={tau}")
        report["composite_fwd"]["max_abs_err"] = max(report["composite_fwd"]["max_abs_err"], err)
        n_loop = torch.minimum(counts, out[5].clamp(min=0))
        ragged += int(((n_loop > 64) & (n_loop % 64 != 0) & (n_loop % 8 != 0)).sum())
        stopped += int((out[2] < 1e-4).sum())
        bwd_args = (*args[:3], out[5], *args[3:7], *out[:4], *cot, pw, ph, tau)
        grads = [in_prefixes(bwd_args, composite_backward(*bwd_args)) for _ in range(2)]
        work = {}
        plain = composite_backward_plain(*bwd_args, work=work)
        sync()
        err = compare_backward(grads[0], plain, f"stress tau={tau}")
        report["composite_bwd"]["max_abs_err"] = max(report["composite_bwd"]["max_abs_err"], err)
        if not torch.equal(grads[0], grads[1]):
            raise AssertionError(f"stress tau={tau}: composite_bwd differs between two runs")
        check_tally(bwd_args, grads[0], work, f"stress tau={tau}")
        idle += int(work["records"]) - int(work["grad_records"])
        print(f"    prefixes min(count, nc_tile): {n_loop.tolist()}; entries of a "
              f"prefix no pixel blends: {int(work['records']) - int(work['grad_records'])} "
              f"of {int(work['records'])}; pixels that stop at T < 1e-4: "
              f"{int((out[2] < 1e-4).sum())}; composite_bwd identical bits on two runs")
    if ragged == 0 or idle == 0 or stopped == 0:
        raise AssertionError(f"stress scene misses a case: {ragged} ragged prefixes "
                             f"longer than a chunk, {idle} idle entries, {stopped} "
                             "stopped pixels")


# tests/test_torch_binning.py's CASES: bin_faces' keywords after the four
# positional sizes, on icosphere(1) in 2 views at 48x40, patches at (0, 0)
# and (5, 3).
BIN_CASES = {
    "rect": dict(capacity=2048, max_tiles_per_face=64, num_giant_faces=0),
    "cull_giant": dict(capacity=2048, max_tiles_per_face=2, num_giant_faces=160,
                       giant_tiles=None, exact_tile_cull=True),
    "giant_overflow": dict(capacity=2048, max_tiles_per_face=1, num_giant_faces=8,
                           giant_tiles=3),
    "capacity_overflow": dict(capacity=100, max_tiles_per_face=4, num_giant_faces=4,
                              exact_tile_cull=True),
}


@contextlib.contextmanager
def captured_binning(module):
    """Record the arguments of each ``bin_faces`` call made through
    ``module`` (``ops/rasterize.py``, ``functional.py``): a list of
    (positional args, keywords)."""
    calls = []
    original = module.bin_faces

    def call(*args, **kwargs):
        calls.append((args, kwargs))
        return original(*args, **kwargs)

    module.bin_faces = call
    try:
        yield calls
    finally:
        module.bin_faces = original


def bench_scene(name, seed, dev):
    """The benchmark's scene of configuration ``name`` at ``seed``, and the
    configuration (``bench_port/configs/<name>.json``)."""
    from bench_port.scene import build_scene

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "bench_port", "configs", f"{name}.json")) as fh:
        config = json.load(fh)
    return build_scene(config, seed, dev), config


@contextlib.contextmanager
def plain_emission():
    """``bin_faces`` over ``emission_keys_plain``, on the card too."""
    from dmesh2_renderer_tpu_torch.ops import binning as TB

    kernel = TB.emission_keys
    TB.emission_keys = TB.emission_keys_plain
    try:
        yield
    finally:
        TB.emission_keys = kernel


def compare_emission(args, kwargs, label):
    """``emission_keys`` (the kernel) against ``emission_keys_plain`` and
    ``bin_faces`` against itself over the plain emission, bit for bit, on
    ``bin_faces``' arguments; raises on any difference. Returns the kernel's
    EmissionKeys and the emission_keys arguments."""
    from dmesh2_renderer_tpu_torch.ops import binning as TB

    aa, depth01, alive, patch_min, pw, ph, capacity, kt = args
    em_args = (aa, depth01, alive, patch_min, pw, ph, -(-capacity // 128) * 128, kt)
    em = TB.emission_keys(*em_args, **kwargs)
    plain = TB.emission_keys_plain(*em_args, **kwargs)
    got = TB.bin_faces(*args, **kwargs)
    with plain_emission():
        want = TB.bin_faces(*args, **kwargs)
    bad = [name for name in em._fields
           if not (torch.equal(getattr(em, name), getattr(plain, name))
                   if isinstance(getattr(em, name), torch.Tensor)
                   else getattr(em, name) == getattr(plain, name))]
    bad += [f"Binning.{name}" for name in got._fields
            if not torch.equal(getattr(got, name), getattr(want, name))]
    slots = em.keys.numel()
    emitted = int((em.keys != TB.SENTINEL).sum())
    print(f"  {label}: {slots} slots, rendered {int(em.num_rendered)}, emitted "
          f"{int(em.num_emitted)} ({emitted} keys), culled {int(em.num_culled)}, "
          f"truncated {int(got.num_truncated)}, giant rows {em.giant_ids.numel()} "
          f"({int((em.giant_ids < depth01.numel()).sum())} used), bits_d {em.bits_d}: "
          + ("equal bit for bit" if not bad else f"DIFFER in {bad}"))
    if bad:
        raise AssertionError(f"bin_emit differs from its plain version ({label}): {bad}")
    if emitted != int(em.num_emitted):
        raise AssertionError(f"{label}: {emitted} keys but num_emitted {int(em.num_emitted)}")
    return em, em_args


def screen_soup(rng, b, f, lo, hi, size, dev):
    """Screen triangles (B, F, 3, 2): centres uniform in [lo, hi] (per axis),
    corner offsets normal at ``size`` pixels."""
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    centres = rng.uniform(lo, hi, size=(b, f, 1, 2)).astype(np.float32)
    offsets = (rng.normal(size=(b, f, 3, 2)) * size).astype(np.float32)
    return torch.as_tensor(centres + offsets, device=dev)


def bin_emit_launch_ms(em_args, kwargs, reps):
    """Each bin_emit launch of one ``emission_keys`` call (the dense grid,
    then the giant rows), replayed ``reps`` times back to back on the card:
    [(device ms per launch, its byte bound in ms, bytes)]. A replay adds to
    the same counts and rewrites the same buffers."""
    from dmesh2_renderer_tpu_torch.ops import binning as TB

    launches = []
    original = TB._bin_emit

    def record(*args, **kw):
        launches.append((args, kw))
        return original(*args, **kw)

    TB._bin_emit = record
    try:
        TB.emission_keys(*em_args, **kwargs)
    finally:
        TB._bin_emit = original
    out = []
    for args, kw in launches:
        bf, rows, cols = args[5], kw["rows"], kw["cols"]
        if kw.get("giant") is None:
            written = (rows * cols + kw["pad"][1]) * 8 + (bf * 4 if kw["select"] is not None else 0)
            read = bf * 29 + args[3].numel() * 4        # corners, depth, alive; origins
        else:
            written = rows * cols * 8 + rows * 4        # keys, payloads; giant_ids
            read = rows * (12 + 29)                      # sorted key and id; the face
        ms = queued_ms(lambda: original(*args, **kw), reps)
        out.append((ms, (written + read) / HBM_BYTES_PER_S * 1e3, written + read))
    return out


def phase_bin_emit(dev, sz: Sizes, report):
    """csrc/bin_emit.cu against emission_keys_plain, bit for bit (module
    docstring, 2e)."""
    from dmesh2_renderer_tpu_torch import LayeredRenderer, RasterConfig, Renderer
    from dmesh2_renderer_tpu_torch import functional
    from dmesh2_renderer_tpu_torch import geometry as G
    from dmesh2_renderer_tpu_torch.ops import binning as TB
    from dmesh2_renderer_tpu_torch.ops import rasterize
    from dmesh2_renderer_tpu_torch.ops.reference import face_depth01
    from dmesh2_renderer_tpu_torch.utils.meshes import icosphere, orbit_cameras

    print("phase 2e: bin_emit (the emission grid) against emission_keys_plain")
    timed = {}
    for seed in sz.bin_seeds:
        scene, config = bench_scene("soup1m_1080p", seed, dev)
        w, h = int(config["width"]), int(config["height"])
        renderer = Renderer(scene.mv, scene.proj, w, h, device=dev,
                            config=RasterConfig(**config["raster"]))
        with torch.no_grad(), captured_binning(rasterize) as calls:
            renderer.forward(list(range(scene.views)), [[0, 0]] * scene.views, w, h,
                             scene.verts, scene.faces, scene.verts_color, scene.faces_opacity,
                             scene.faces_intense, scene.background,
                             float(config["aa_temperature"]))
        args, kwargs = calls[-1]
        em, em_args = compare_emission(args, kwargs, f"soup1m_1080p seed {seed}")
        timed.setdefault("soup1m_1080p", (em_args, kwargs, em))
        del renderer, scene, calls, args, em
    scene, config = bench_scene("tetgrid32_1080p", sz.bin_seeds[-1], dev)
    w, h = int(config["width"]), int(config["height"])
    layered = LayeredRenderer(scene.mv, scene.proj, w, h, device=dev,
                              config=RasterConfig(**config["raster"]))
    with captured_binning(functional) as calls:
        layered.generate(list(range(scene.views)), scene.verts, scene.faces, scene.tets,
                         scene.face_tets, scene.tet_faces, scene.exist, sz.layered_layers)
    args, kwargs = calls[-1]
    em, em_args = compare_emission(args, kwargs, "tetgrid32_1080p")
    timed["tetgrid32_1080p"] = (em_args, kwargs, em)
    del layered, scene, calls, args, em

    # tests/test_torch_binning.py's cases.
    verts, faces = (torch.as_tensor(a, device=dev) for a in icosphere(1))
    mv, proj = (torch.as_tensor(a, device=dev) for a in orbit_cameras(2))
    verts_ndc, verts_image = G.compute_verts_ndc_image(verts, mv, proj, 48, 40)
    aa = G.face_aa_verts_ccw(verts_image, faces)
    depth01, _, _, alive = face_depth01(verts_ndc, faces)
    pm = torch.tensor([[0, 0], [5, 3]], dtype=torch.int32, device=dev)
    for name, kw in BIN_CASES.items():
        kw = dict(kw)
        size = (kw.pop("capacity"), kw.pop("max_tiles_per_face"))
        compare_emission((aa, depth01, alive, pm, 48, 40, *size), kw, f"case {name}")

    # A 2x2-tile grid: 28 depth bits, depths at exactly 0 and 1.
    rng = np.random.default_rng(11)
    f = 3000
    aa = screen_soup(rng, 1, f, (-8, -8), (40, 40), 6.0, dev)
    depth01 = torch.as_tensor(rng.choice(np.float32([0.0, 1.0, 0.25, 1 - 2 ** -24]),
                                         size=(1, f)), device=dev)
    alive = torch.as_tensor(rng.uniform(size=(1, f)) < 0.9, device=dev)
    pm = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    for cull in (True, False):
        em, _ = compare_emission((aa, depth01, alive, pm, 32, 32, 1 << 15, 2),
                                 dict(num_giant_faces=64, exact_tile_cull=cull),
                                 f"2x2 tiles, depths 0 and 1, cull {cull}")
        if em.bits_d < 25:
            raise AssertionError(f"the 2x2-tile grid keeps {em.bits_d} depth bits")

    # Faces leaving a ragged 333x201 frame on every side (some by 1e30).
    f = 20000
    aa = screen_soup(rng, 2, f, (-300, -200), (633, 400), 60.0, dev)
    far = torch.as_tensor(rng.choice(np.float32([-1e30, 1e30]), size=(2, 50, 3, 2)), device=dev)
    aa[:, :50] = far
    depth01 = torch.as_tensor(rng.uniform(size=(2, f)).astype(np.float32), device=dev)
    alive = torch.as_tensor(rng.uniform(size=(2, f)) < 0.9, device=dev)
    pm = torch.tensor([[0, 0], [17, 9]], dtype=torch.int32, device=dev)
    for cull in (True, False):
        compare_emission((aa, depth01, alive, pm, 333, 201, 1 << 20, 8),
                         dict(num_giant_faces=512, giant_tiles=40, exact_tile_cull=cull),
                         f"off-frame soup 333x201, cull {cull}")

    print(f"  device time per launch ({sz.bin_reps} launches queued back to back) beside "
          f"its byte bound at {HBM_BYTES_PER_S:.3g} B/s; emission_keys and bin_faces "
          "against their plain versions:")
    result = {}
    for name, (em_args, kwargs, em) in timed.items():
        launches = bin_emit_launch_ms(em_args, kwargs, sz.bin_reps)
        for what, (ms, bound, nbytes) in zip(("dense grid", "giant rows"), launches):
            print(f"    {name} {what}: {ms:.4f} ms, bound {bound:.4f} ms "
                  f"({nbytes} bytes, {100 * bound / ms:.1f}% of the bound)")
        em_ms, _ = time_ms(lambda: TB.emission_keys(*em_args, **kwargs), sz.reps)
        plain_ms, _ = time_ms(lambda: TB.emission_keys_plain(*em_args, **kwargs), sz.plain_reps)
        bin_ms, _ = time_ms(lambda: TB.bin_faces(*em_args, **kwargs), sz.reps)
        with plain_emission():
            bin_plain_ms, _ = time_ms(lambda: TB.bin_faces(*em_args, **kwargs),
                                      sz.plain_reps)
        print(f"    {name}: emission_keys {em_ms:.3f} ms (plain {plain_ms:.3f}), bin_faces "
              f"{bin_ms:.3f} ms (plain emission {bin_plain_ms:.3f}), "
              f"{em.keys.numel()} slots")
        result[name] = dict(
            launch_ms=[x[0] for x in launches], launch_bound_ms=[x[1] for x in launches],
            launch_bytes=[x[2] for x in launches], emission_keys_ms=em_ms,
            emission_keys_plain_ms=plain_ms, bin_faces_ms=bin_ms,
            bin_faces_plain_emission_ms=bin_plain_ms, slots=em.keys.numel())
    soup = result["soup1m_1080p"]
    report["bin_emit"].update(
        ms=sum(soup["launch_ms"]), plain_ms=soup["emission_keys_plain_ms"],
        bound_ms=sum(soup["launch_bound_ms"]), bound_by="bytes", library_ms=None,
        timed_on="soup1m_1080p, both launches")
    return dict(bin_emit=result)


@contextlib.contextmanager
def captured_reductions():
    """Record the arguments of the backward's two reductions as a training
    step calls them (``reduce_entry_grads`` in ``ops/rasterize.py``,
    ``aa_cotangent_to_verts_image`` in ``geometry.py``): name -> args."""
    from dmesh2_renderer_tpu_torch import geometry as G
    from dmesh2_renderer_tpu_torch.ops import rasterize

    calls = {}
    sites = ((rasterize, "reduce_entry_grads"), (G, "aa_cotangent_to_verts_image"))
    originals = [getattr(m, n) for m, n in sites]

    def recording(name, fn):
        def call(*args):
            calls[name] = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                                for a in args)
            return fn(*args)
        return call

    for (m, n), fn in zip(sites, originals):
        setattr(m, n, recording(n, fn))
    try:
        yield calls
    finally:
        for (m, n), fn in zip(sites, originals):
            setattr(m, n, fn)


def order_bound(kernel, plain, plain_fn, args, label):
    """Hold each output of ``kernel`` to ``plain`` (tuples of tensors): an
    element may differ by 2 (n - 1) u S, S its sum of absolute terms
    (``plain_fn`` on |the first argument|), n the most terms any element
    sums (``plain_fn`` on the first argument's non-zeros, as ones), u = 2^-24,
    plus n times the smallest normal float (atomics flush subnormals to
    zero). Raises beyond it; returns (largest |difference|, largest share of
    its bound, n)."""
    x = args[0]
    mag = plain_fn(x.abs(), *args[1:])
    terms = plain_fn((x != 0).float(), *args[1:])
    n = max(float(t.max()) for t in terms if t.numel())
    u = 2.0 ** -24
    worst = share = 0.0
    for i, (k, p, m) in enumerate(zip(kernel, plain, mag)):
        if not torch.isfinite(k).all():
            raise AssertionError(f"{label}: output {i} not finite")
        diff = (k - p).abs()
        bound = 2.0 * max(n - 1.0, 0.0) * u * m + n * torch.finfo(torch.float32).tiny
        if bool((diff > bound).any()):
            raise AssertionError(f"{label}: output {i} differs by {float(diff.max())}, "
                                 f"beyond 2 (n - 1) u S (n = {n:.0f})")
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        share = max(share, float((diff / bound.clamp(min=1e-38)).max())
                    if diff.numel() else 0.0)
    return worst, share, n


def phase_grad_reduce(dev, sz: Sizes, report):
    """csrc/grad_reduce.cu against the plain reductions, and timed (module
    docstring, 2f)."""
    from dmesh2_renderer_tpu_torch import RasterConfig, Renderer
    from dmesh2_renderer_tpu_torch import geometry as G
    from dmesh2_renderer_tpu_torch.ops import _kernels
    from dmesh2_renderer_tpu_torch.ops.binning import contributing_mask
    from dmesh2_renderer_tpu_torch.ops.composite_bwd import (
        GRAD_COLUMNS, reduce_entry_grads, reduce_entry_grads_plain, scatter_entry_grads)

    print("phase 2f: grad_reduce (the gradient reduction) against the plain reductions")
    result = {}
    for name in sz.reduce_configs:
        scene, config = bench_scene(name, sz.reduce_seed, dev)
        w, h = int(config["width"]), int(config["height"])
        renderer = Renderer(scene.mv, scene.proj, w, h, device=dev,
                            config=RasterConfig(**config["raster"]))
        params = {k: getattr(scene, k).detach().clone().requires_grad_(True)
                  for k in TRAINABLE}
        kernels = (_kernels.GRAD_REDUCE, _kernels.CORNER_REDUCE)
        reset_launches(kernels)
        with captured_reductions() as calls:
            color, depth = renderer.forward(
                list(range(scene.views)), [[0, 0]] * scene.views, w, h, params["verts"],
                scene.faces, params["verts_color"], params["faces_opacity"],
                params["faces_intense"], scene.background, float(config["aa_temperature"]))
            (color.sum() + depth.sum()).backward()
        launches = read_launches(kernels)
        if launches != {"grad_reduce": 1, "corner_reduce": 1}:
            raise AssertionError(f"{name}: one training step launched {launches}")
        del color, depth, params, renderer
        args = calls["reduce_entry_grads"]
        g, neg, faces, n_verts = calls["aa_cotangent_to_verts_image"]
        grad_records, entry_bf, starts, counts, nc_tile = args[:5]
        r = grad_records.shape[0]
        keep, n_contrib = contributing_mask(starts, counts, nc_tile, r)
        n_contrib = int(n_contrib)
        # The table outside the prefixes is unset: give the plain versions,
        # which read every row, zeros there.
        rec0 = torch.where(keep[:, None], grad_records, 0.0)
        plain_args = (rec0, *args[1:])
        label = f"{name} ({scene.views} views)"

        kernel = reduce_entry_grads(*args)
        again = reduce_entry_grads(*args)
        plain = reduce_entry_grads_plain(*plain_args)
        err, share, n = order_bound(kernel, plain, reduce_entry_grads_plain, plain_args,
                                    f"{label} reduce_entry_grads vs plain")
        chain = list(scatter_entry_grads(rec0, entry_bf, faces, n_verts, args[7], keep))
        d_vndc = torch.zeros_like(kernel[3])
        d_vndc[..., 2] = chain[3]
        chain[3] = d_vndc
        err2, share2, _ = order_bound(kernel, chain, reduce_entry_grads_plain, plain_args,
                                      f"{label} reduce_entry_grads vs scatter_entry_grads")
        runs = max(float((a - b).abs().max()) for a, b in zip(kernel, again))
        print(f"  {label}: reduce_entry_grads within 2 (n - 1) u S of the plain version "
              f"(max|diff| {err:.3g}, {100 * share:.2f}% of its bound at most, n = {n:.0f}) "
              f"and of mask + scatter_entry_grads (max|diff| {err2:.3g}, "
              f"{100 * share2:.2f}%); two kernel runs differ by up to {runs:.3g}")
        corner = G.aa_cotangent_to_verts_image(g, neg, faces, n_verts)
        corner_plain = G.aa_cotangent_to_verts_image_plain(g, neg, faces, n_verts)
        cerr, cshare, cn = order_bound(
            (corner,), (corner_plain,),
            lambda *a: (G.aa_cotangent_to_verts_image_plain(*a),), (g, neg, faces, n_verts),
            f"{label} aa_cotangent_to_verts_image vs plain")
        for kernel_name, e in (("grad_reduce", max(err, err2)), ("corner_reduce", cerr)):
            report[kernel_name]["max_abs_err"] = max(report[kernel_name]["max_abs_err"], e)
        print(f"  {label}: aa_cotangent_to_verts_image within 2 (n - 1) u S of its plain "
              f"version (max|diff| {cerr:.3g}, {100 * cshare:.2f}%, n = {cn:.0f}); "
              f"identical bits {torch.equal(corner, corner_plain)}")

        # Bytes: the prefixes' records and entry ids, the tile arrays, the
        # faces once, each output written once.
        outs = sum(t.numel() for t in kernel) * 4
        nbytes = n_contrib * (GRAD_COLUMNS * 4 + 4) + 3 * starts.numel() * 4 + \
            faces.numel() * 4 + outs
        cbytes = g.numel() * 4 + neg.numel() + faces.numel() * 4 + corner.numel() * 4

        def old_chain():
            kp, _ = contributing_mask(starts, counts, nc_tile, r)
            out = scatter_entry_grads(grad_records, entry_bf, faces, n_verts, args[7], kp)
            z = torch.zeros_like(kernel[3])
            z[..., 2] = out[3]
            return out

        image = torch.zeros((neg.shape[0], n_verts, 2), device=dev, requires_grad=True)
        gathered = G._face_aa_verts_impl(image, faces)[0]
        t = dict(
            kernel_ms=time_ms(lambda: reduce_entry_grads(*args), sz.reps)[0],
            kernel_queued_ms=queued_ms(lambda: reduce_entry_grads(*args), sz.bin_reps),
            plain_ms=time_ms(lambda: reduce_entry_grads_plain(*plain_args), sz.reps)[0],
            replaced_chain_ms=time_ms(old_chain, sz.reps)[0],
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
            corner_kernel_ms=time_ms(lambda: G.aa_cotangent_to_verts_image(
                g, neg, faces, n_verts), sz.reps)[0],
            corner_kernel_queued_ms=queued_ms(lambda: G.aa_cotangent_to_verts_image(
                g, neg, faces, n_verts), sz.bin_reps),
            corner_index_add_ms=time_ms(lambda: G.aa_cotangent_to_verts_image_plain(
                g, neg, faces, n_verts), sz.reps)[0],
            corner_autograd_gather_ms=time_ms(lambda: torch.autograd.grad(
                gathered, image, g, retain_graph=True), sz.reps)[0],
            corner_bound_ms=cbytes / HBM_BYTES_PER_S * 1e3, corner_bytes=cbytes,
            contributing_rows=n_contrib, rows=r, max_terms=n,
            max_abs_diff_plain=err, max_abs_diff_chain=err2, max_abs_diff_runs=runs,
            corner_max_abs_diff=cerr)
        print(f"  {label}: {n_contrib} contributing rows of {r}; reduce_entry_grads "
              f"{t['kernel_ms']:.3f} ms ({t['kernel_queued_ms']:.3f} queued), bound "
              f"{t['bound_ms']:.3f} ms ({nbytes} bytes), plain {t['plain_ms']:.3f} ms, the "
              f"replaced mask + sync + gather + index_add_ {t['replaced_chain_ms']:.3f} ms")
        print(f"  {label}: corners: kernel {t['corner_kernel_ms']:.3f} ms "
              f"({t['corner_kernel_queued_ms']:.3f} queued), index_add_ "
              f"{t['corner_index_add_ms']:.3f} ms, autograd of the gather "
              f"{t['corner_autograd_gather_ms']:.3f} ms, bound {t['corner_bound_ms']:.3f} ms")
        result[name] = t
        del calls, args, plain_args, kernel, again, plain, chain, rec0, g, neg, gathered
        del image, corner, corner_plain, scene
        torch.cuda.empty_cache()
    main = result[sz.reduce_configs[0]]
    report["grad_reduce"].update(
        ms=main["kernel_ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by="bytes", library_ms=None, replaced_ms=main["replaced_chain_ms"],
        timed_on=f"{sz.reduce_configs[0]}, one training step's reduction")
    report["corner_reduce"].update(
        ms=main["corner_kernel_ms"], plain_ms=main["corner_index_add_ms"],
        bound_ms=main["corner_bound_ms"], bound_by="bytes", library_ms=None,
        replaced_ms=main["corner_autograd_gather_ms"],
        timed_on=f"{sz.reduce_configs[0]}, one training step's AA corners")
    return dict(grad_reduce=result)


def headline_scene(dev, sz: Sizes):
    from dmesh2_renderer_tpu_torch import RasterConfig
    from dmesh2_renderer_tpu_torch.utils.meshes import orbit_cameras, triangle_soup

    verts, faces = triangle_soup(sz.n_faces, size=0.02)
    mv, proj = orbit_cameras(1, radius=3.0)
    f = faces.shape[0]
    s = dict(
        verts=torch.as_tensor(verts, device=dev),
        faces=torch.as_tensor(faces, device=dev),
        verts_color=torch.as_tensor(np.abs(verts) % 1.0, device=dev),
        faces_opacity=torch.full((f,), 0.5, device=dev),
        faces_intense=torch.ones((1, f), device=dev),
        background=torch.zeros(3, device=dev),
    )
    config = RasterConfig(binning_capacity=sz.capacity, max_tiles_per_face=12,
                          num_giant_faces=16384, giant_tiles=40,
                          exact_tile_cull=True)
    return s, mv, proj, config


def training_step(forward, params):
    """One training step: ``forward(params)``, then ``loss.backward()`` of
    ``color.sum() + depth.sum()`` into freshly cleared gradients."""
    for t in params.values():
        t.grad = None
    color, depth = forward(params)
    (color.sum() + depth.sum()).backward()


def check_grads(params, label):
    for k, t in params.items():
        g = t.grad
        if g is None or not torch.isfinite(g).all() or not bool((g != 0).any()):
            raise AssertionError(f"{label}: gradient of {k} missing, not finite or zero")
    print(f"  {label}: gradients finite and non-zero; max|grad| " + ", ".join(
        f"{k} {float(t.grad.abs().max()):.4g}" for k, t in params.items()))


def phase_main_path(dev, sz: Sizes, report, kernels):
    from dmesh2_renderer_tpu_torch import Renderer

    print(f"phase 3: main path, one training step (Renderer.forward + "
          f"loss.backward()), {sz.n_faces} faces at {sz.width}x{sz.height}")
    s, mv, proj, config = headline_scene(dev, sz)
    renderer = Renderer(mv, proj, sz.width, sz.height, config=config)
    params = leaves_of(s)

    def forward(p):
        return renderer.forward([0], [[0, 0]], sz.width, sz.height, p["verts"],
                                s["faces"], p["verts_color"], p["faces_opacity"],
                                p["faces_intense"], s["background"], 1.0)

    reset_launches(kernels)
    with captured_kernel_calls() as calls:
        color, depth = forward(params)
        (color.sum() + depth.sum()).backward()
    launches = read_launches(kernels)
    color, depth = color.detach(), depth.detach()
    aux = [int(x) for x in renderer.last_aux]
    print(f"  launches on the main path: {launches}")
    print(f"  aux: num_rendered={aux[0]} num_truncated={aux[1]} "
          f"num_grad_contributing={aux[2]}")
    record_launches(report, launches, TRAINING_KERNELS, "training step")
    if not (torch.isfinite(color).all() and torch.isfinite(depth).all()):
        raise AssertionError("main path output is not finite")
    if tuple(color.shape) != (1, sz.height, sz.width, 3):
        raise AssertionError(f"main path colour shape {tuple(color.shape)}")
    if aux[1] != 0:
        raise AssertionError(f"main path truncated {aux[1]} entries")
    covered = int((color.sum(-1) > 0).sum())
    print(f"  non-background pixels: {covered} of {sz.width * sz.height}; "
          f"colour range [{float(color.min()):.4f}, {float(color.max()):.4f}]")
    if covered == 0:
        raise AssertionError("main path rendered only background")
    check_grads(params, "training step")

    # The kernels' outputs of that step vs their plain versions on the card,
    # counting the compositing work these inputs need for the bounds.
    work, bwd_work = {}, {}
    main_label = f"main {sz.width}x{sz.height}"
    check_kernels(calls, main_label, report, work=work)
    check_backward(calls, main_label, report, work=bwd_work)
    pairs = int(bwd_work["blend_pairs"])
    report["composite_bwd"]["lane_occupancy"] = dict(
        gradient_pass=pairs / (32 * int(bwd_work["grad_batches"])),
        one_thread_per_pixel=pairs / (32 * int(bwd_work["blend_warp_entries"])))
    print("  work these inputs need (plain versions' counts): forward "
          f"{ {k: int(v) for k, v in work.items()} }, backward "
          f"{ {k: int(v) for k, v in bwd_work.items()} }")

    # Determinism: the backward kernel again, twice, on the same inputs.
    from dmesh2_renderer_tpu_torch.ops.composite_bwd import composite_backward
    bwd_args, bwd_out = calls["composite_backward"]
    bwd_out = in_prefixes(bwd_args, bwd_out)
    same = all(torch.equal(bwd_out, in_prefixes(bwd_args, composite_backward(*bwd_args)))
               for _ in range(2))
    print(f"  composite_bwd on the {main_label} inputs, three runs: identical bits {same}")
    if not same:
        raise AssertionError("composite_bwd is not deterministic")

    # A 256x256 window of the same scene, through the same forward.
    x0, y0, pw, ph = sz.patch
    with captured_kernel_calls() as patch_calls:
        renderer.forward([0], [[x0, y0]], pw, ph, *scene_args(s), 1.0)
    check_kernels(patch_calls, f"patch {pw}x{ph}", report)
    return renderer, s, forward, calls, work, bwd_work


def reset_launches(kernels):
    """Set every kernel's launch count to 0 (after the card is idle)."""
    sync()
    for k in kernels:
        k.launches = 0


def read_launches(kernels):
    """Every kernel's launch count, once the card is idle."""
    sync()
    return {k.name: k.launches for k in kernels}


def record_launches(report, launches, path_kernels, label):
    """Add each path kernel's launch count to its total over the main-path
    runs; raise if one did not launch on this path."""
    for name in path_kernels:
        report[name]["launches"] += launches[name]
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched on the {label} path")


def phase_training(dev, sz: Sizes, renderer, s, forward):
    """A few Adam steps on (verts, verts_color, faces_opacity) toward a
    target rendered from the same scene with perturbed colours."""
    print(f"phase 3b: {sz.adam_steps} Adam steps toward a target with "
          "perturbed colours")
    gen = torch.Generator(device=dev).manual_seed(7)
    target_colors = (s["verts_color"] + 0.2 * torch.randn(
        s["verts_color"].shape, generator=gen, device=dev)).clamp(0.0, 1.0)
    with torch.no_grad():
        target, _ = forward(dict(s, verts_color=target_colors))
    p = leaves_of(s)
    opt = torch.optim.Adam([
        dict(params=[p["verts"]], lr=1e-4),
        dict(params=[p["verts_color"]], lr=1e-2),
        dict(params=[p["faces_opacity"]], lr=1e-3),
    ])
    losses = []
    for _ in range(sz.adam_steps):
        opt.zero_grad(set_to_none=True)
        color, _ = forward(p)
        loss = ((color - target) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    print("  loss per step: " + ", ".join(f"{x:.6g}" for x in losses))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"Adam steps did not lower the loss: {losses}")
    return losses


def composite_bound(comp_args, work):
    """Least time for the compositing work these inputs need (``work`` from
    the plain version): the records each tile walks until its last pixel
    stops, the rays and the outputs, against the pixel-dependent float
    operations of each class of (face, pixel) pair."""
    from dmesh2_renderer_tpu_torch.ops.composite_fwd import (
        OPS_PER_AA_PAIR, OPS_PER_BBOX_PAIR, OPS_PER_BLEND_PAIR, OPS_PER_PAIR)

    _, _, counts, ray_o, ray_d, bg, patch_min, pw, ph, tau = comp_args
    w = {k: int(v) for k, v in work.items()}
    n_pix = ray_d.shape[0] * ph * pw
    nbytes = (w["records"] * 128 + (ray_d.numel() + ray_o.numel() + bg.numel()
                                    + patch_min.numel()) * 4
              + 3 * counts.numel() * 4 + n_pix * (3 + 4) * 4)
    ops = (w["pairs"] * OPS_PER_PAIR
           + w["bbox_pairs"] * (OPS_PER_BBOX_PAIR + (OPS_PER_AA_PAIR if tau > 0 else 0))
           + w["blend_pairs"] * OPS_PER_BLEND_PAIR)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), \
        dict(w, bytes=nbytes, ops=ops)


def backward_bound(bwd_args, work):
    """Least time for the backward compositing work these inputs need
    (``work`` from the plain version): the contributing records walked, the
    (R, 32) output written once, 14 floats per pixel (ray 3, cotangents 5,
    residuals 6) and the tile arrays, against the forward's per-pair
    operations paid again in the replay plus the gradient fields of each
    blending pair and the block sum and epilogue of each entry."""
    from dmesh2_renderer_tpu_torch.ops.composite_bwd import (
        OPS_PER_AA_GRAD_PAIR, OPS_PER_GRAD_ENTRY, OPS_PER_GRAD_PAIR)
    from dmesh2_renderer_tpu_torch.ops.composite_fwd import (
        OPS_PER_AA_PAIR, OPS_PER_BBOX_PAIR, OPS_PER_BLEND_PAIR, OPS_PER_PAIR)

    records, counts, ray_d, tau = bwd_args[0], bwd_args[2], bwd_args[5], bwd_args[-1]
    pw, ph = bwd_args[-3], bwd_args[-2]
    w = {k: int(v) for k, v in work.items()}
    n_pix = ray_d.shape[0] * ph * pw
    nbytes = (w["records"] * 128 + records.shape[0] * 128 + n_pix * 14 * 4
              + 3 * counts.numel() * 4)
    aa = tau > 0
    ops = (w["pairs"] * OPS_PER_PAIR
           + w["bbox_pairs"] * (OPS_PER_BBOX_PAIR + (OPS_PER_AA_PAIR if aa else 0))
           + w["blend_pairs"] * (OPS_PER_BLEND_PAIR + OPS_PER_GRAD_PAIR
                                 + (OPS_PER_AA_GRAD_PAIR if aa else 0))
           + w["grad_records"] * OPS_PER_GRAD_ENTRY)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), \
        dict(w, bytes=nbytes, ops=ops)


def phase_timing(dev, sz: Sizes, report, renderer, s, forward, calls, work,
                 bwd_work):
    from dmesh2_renderer_tpu_torch.ops.binning import (
        bin_faces, emission_keys, pack_stream, pack_stream_plain)
    from dmesh2_renderer_tpu_torch.ops.composite_bwd import (
        composite_backward, composite_backward_plain, reduce_entry_grads)
    from dmesh2_renderer_tpu_torch.ops.composite_fwd import (
        composite_forward, composite_forward_plain)
    from dmesh2_renderer_tpu_torch.ops.reference import face_depth01
    from dmesh2_renderer_tpu_torch import geometry as G

    print(f"phase 4: timing (median of {sz.reps} after warm-up; plain versions "
          f"median of {sz.plain_reps})")
    fwd_ms, fwd_all = time_ms(lambda: forward(s), sz.reps, warmup=2)
    mpix = sz.width * sz.height / (fwd_ms * 1e3)
    print(f"  forward {sz.width}x{sz.height}: {fwd_ms:.3f} ms  ({mpix:.2f} Mpix/s); "
          f"runs {[round(t, 3) for t in fwd_all]}")
    timings = dict(forward_ms=fwd_ms, forward_runs_ms=fwd_all, mpix_per_s=mpix)

    # The training step (forward + backward of color.sum() + depth.sum())
    # and the backward alone (retained graph of one forward).
    p = leaves_of(s)
    step_ms, step_all = time_ms(lambda: training_step(forward, p), sz.reps, warmup=2)
    color, depth = forward(p)
    loss = color.sum() + depth.sum()
    bwd_ms, bwd_all = time_ms(lambda: loss.backward(retain_graph=True), sz.reps)
    del color, depth, loss
    print(f"  training step {sz.width}x{sz.height}: {step_ms:.3f} ms; runs "
          f"{[round(t, 3) for t in step_all]}; backward alone {bwd_ms:.3f} ms; runs "
          f"{[round(t, 3) for t in bwd_all]}")
    timings.update(train_step_ms=step_ms, train_step_runs_ms=step_all,
                   backward_ms=bwd_ms, backward_runs_ms=bwd_all)


    # Record pack, its plain version and the index_select yardstick, on the
    # main path's own inputs.
    pack_args, records = calls["pack_stream"]
    r_entries = records.shape[0]
    entry_bf, faces, verts, vcol, vndc, op, inten, aa = pack_args
    bf = inten.numel()
    table = pack_stream_plain(torch.arange(bf, dtype=torch.int32, device=dev), *pack_args[1:])
    safe = torch.clamp(entry_bf.long(), max=bf - 1)
    pack_ms, _ = time_ms(lambda: pack_stream(*pack_args), sz.reps)
    pack_plain_ms, _ = time_ms(lambda: pack_stream_plain(*pack_args), sz.plain_reps)
    lib_ms, _ = time_ms(lambda: table.index_select(0, safe), sz.reps)
    pack_bytes = (r_entries * 128 + r_entries * 4 + faces.numel() * 4
                  + (verts.numel() + vcol.numel() + vndc.numel() + op.numel()
                     + inten.numel() + aa.numel()) * 4)
    pack_bound = pack_bytes / HBM_BYTES_PER_S * 1e3
    report["pack_stream"].update(ms=pack_ms, plain_ms=pack_plain_ms, bound_ms=pack_bound,
                                 bound_by="bytes", library_ms=lib_ms)
    print(f"  pack_stream: {pack_ms:.3f} ms ({pack_bytes / pack_ms / 1e9:.3f} TB/s), "
          f"plain {pack_plain_ms:.3f} ms, index_select {lib_ms:.3f} ms, bound "
          f"{pack_bound:.3f} ms ({r_entries} records, {pack_bytes} bytes)")

    # Tile compositor on the main path's own inputs.
    comp_args, _ = calls["composite_forward"]
    comp_ms, _ = time_ms(lambda: composite_forward(*comp_args), sz.reps)
    comp_plain_ms, _ = time_ms(lambda: composite_forward_plain(*comp_args),
                               sz.plain_reps, warmup=0)
    bound, bound_by, comp_work = composite_bound(comp_args, work)
    report["composite_fwd"].update(ms=comp_ms, plain_ms=comp_plain_ms, bound_ms=bound,
                                   bound_by=bound_by, library_ms=None)
    print(f"  composite_fwd: {comp_ms:.3f} ms, plain {comp_plain_ms:.3f} ms, "
          f"bound {bound:.3f} ms ({bound_by}; {comp_work})")
    timings.update(composite_work=comp_work)

    # Where the forward's time goes: each stage at the main path's inputs.
    mv, proj = renderer.mv[:1], renderer.proj[:1]
    patch_min = comp_args[6]
    config = renderer.config
    depth01, _, _, alive = face_depth01(vndc, faces)
    bin_kw = dict(num_giant_faces=config.num_giant_faces,
                  giant_tiles=config.giant_tiles,
                  exact_tile_cull=config.exact_tile_cull)
    capacity = -(-config.binning_capacity // 128) * 128
    em = emission_keys(aa, depth01, alive, patch_min, sz.width, sz.height, capacity,
                       config.max_tiles_per_face, **bin_kw)
    stages = {
        "project": time_ms(lambda: G.face_aa_verts_ccw(G.compute_verts_ndc_image(
            verts, mv, proj, sz.width, sz.height)[1], faces), sz.reps)[0],
        "depth_cull": time_ms(lambda: face_depth01(vndc, faces), sz.reps)[0],
        "emission_keys": time_ms(lambda: emission_keys(
            aa, depth01, alive, patch_min, sz.width, sz.height, capacity,
            config.max_tiles_per_face, **bin_kw), sz.reps)[0],
        "bin_faces": time_ms(lambda: bin_faces(
            aa, depth01, alive, patch_min, sz.width, sz.height,
            config.binning_capacity, config.max_tiles_per_face, **bin_kw), sz.reps)[0],
        "sort": time_ms(lambda: torch.sort(em.keys, stable=True), sz.reps)[0],
        "pack_stream": pack_ms,
        "composite_fwd": comp_ms,
    }
    staged = sum(stages[k] for k in ("project", "depth_cull", "bin_faces",
                                     "pack_stream", "composite_fwd"))
    stages["rest_of_forward"] = fwd_ms - staged
    print("  stages (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"  [bin_faces includes emission_keys and the sort of "
          f"{em.keys.numel()} int32 keys]")
    timings.update(stages_ms=stages, sort_ms=stages["sort"], sort_keys=em.keys.numel(),
                   pack_bytes=pack_bytes, records=r_entries)

    # Backward compositor on the main path's own inputs.
    bwd_args, grad_records = calls["composite_backward"]
    cb_ms, _ = time_ms(lambda: composite_backward(*bwd_args), sz.reps)
    cb_plain_ms, _ = time_ms(lambda: composite_backward_plain(*bwd_args),
                             sz.plain_reps, warmup=0)
    bound, bound_by, cb_work = backward_bound(bwd_args, bwd_work)
    report["composite_bwd"].update(ms=cb_ms, plain_ms=cb_plain_ms, bound_ms=bound,
                                   bound_by=bound_by, library_ms=None)
    print(f"  composite_bwd: {cb_ms:.3f} ms, plain {cb_plain_ms:.3f} ms, "
          f"bound {bound:.3f} ms ({bound_by}; {cb_work})")

    # Where the backward's time goes: the reduction (grad_reduce) and the
    # autograd tail (projection and AA corners back to verts) on the same
    # inputs.
    starts, counts, nc_tile = bwd_args[1], bwd_args[2], bwd_args[3]
    n_verts, n_batch = verts.shape[0], inten.shape[0]

    def reduce():
        return reduce_entry_grads(grad_records, entry_bf, starts, counts, nc_tile, faces,
                                  n_verts, n_batch)

    red_ms, _ = time_ms(reduce, sz.reps)
    d = reduce()
    d_vndc = d[3]
    v_leaf = verts.clone().requires_grad_(True)
    vndc_t, vimg_t = G.compute_verts_ndc_image(v_leaf, mv, proj, sz.width, sz.height)
    aa_t = G.face_aa_verts_ccw(vimg_t, faces)
    tail_ms, _ = time_ms(lambda: torch.autograd.grad(
        (vndc_t, aa_t), v_leaf, (d_vndc, d[5]), retain_graph=True), sz.reps)
    bwd_stages = {"composite_bwd": cb_ms, "reduction": red_ms, "autograd_tail": tail_ms}
    bwd_stages["rest_of_backward"] = bwd_ms - sum(bwd_stages.values())
    print("  backward stages (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in bwd_stages.items()))
    timings.update(backward_stages_ms=bwd_stages, backward_work=cb_work)
    return timings


def phase_device_busy(sz: Sizes, s, forward, sharded):
    """The card's busy time in the 1080p forward and training step, and in
    the ``sharded`` forwards (name -> call: the face slabs and the pixel
    bands of phases 6f and 6g), under torch.profiler. Last of all: after
    the profiler has run, the host launches more slowly, which would move
    every timing taken after it."""
    print("phase 7: device busy time under torch.profiler (the profiler slows "
          "the host, so the share is a lower bound)")
    p = leaves_of(s)
    out = {}
    for key, fn in (("forward", lambda: forward(s)),
                    ("train_step", lambda: training_step(forward, p)),
                    *sharded.items()):
        wall, busy = device_busy(fn)
        share = f"{busy / wall:.1%}" if busy > 0 else "not measured"
        print(f"  {key} {sz.width}x{sz.height}: {wall:.3f} ms per call, card busy "
              f"{busy:.3f} ms ({share})")
        out.update({f"{key}_profiled_ms": wall,
                    f"{key}_device_busy_ms": busy if busy > 0 else None})
    return out


def brute_force_layers(verts, faces, exist, ray_o, ray_d, num_layers, pixels):
    """The numpy oracle of tests/test_peel.py for the (y, x) ``pixels`` of
    one view: every existing face against the ray in float32, the first L
    hits by t (a stable sort: equal t in face-id order).

    Returns (layers (n, L) int32, counts (n,) int32, tie (n,) bool), ``tie``
    marking pixels where two of the first L + 1 hits share one t: there the
    peel's tie rule (one layer, the larger id, inside one 128-entry block)
    may order or merge them differently.
    """
    v = verts[faces].astype(np.float32)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    t0 = ray_o - v[:, 0]
    qv = np.cross(t0, e1)
    qe2 = (qv * e2).sum(1)
    n = len(pixels)
    layers = np.full((n, num_layers), -1, np.int32)
    counts = np.zeros(n, np.int32)
    tie = np.zeros(n, bool)
    for i, (y, x) in enumerate(pixels):
        rd = ray_d[y, x]
        pv = np.cross(np.broadcast_to(rd, e2.shape), e2)
        den = (pv * e1).sum(1)
        ok = den != 0
        inv = np.where(ok, 1.0 / np.where(ok, den, 1.0), 0.0).astype(np.float32)
        tt = (qe2 * inv).astype(np.float32)
        u = ((pv * t0).sum(1) * inv).astype(np.float32)
        vv = ((qv * rd).sum(1) * inv).astype(np.float32)
        hit = ok & (tt >= 0) & (u >= 0) & (vv >= 0) & (u + vv <= 1) & (exist > 0)
        ids = np.nonzero(hit)[0]
        order = ids[np.argsort(tt[ids], kind="stable")]
        layers[i, :min(len(order), num_layers)] = order[:num_layers]
        counts[i] = min(len(order), num_layers)
        ts = tt[order[:num_layers + 1]]
        tie[i] = len(np.unique(ts)) < len(ts)
    return layers, counts, tie


def ray_t(verts, faces, ray_o, rd, ids):
    """Moeller-Trumbore t of the ray ``rd`` with each face of ``ids``, in
    the float32 arithmetic of :func:`brute_force_layers`."""
    v = verts[faces[ids]].astype(np.float32)
    e1, e2, t0 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], ray_o - v[:, 0]
    pv = np.cross(np.broadcast_to(rd, e2.shape), e2)
    inv = (1.0 / (pv * e1).sum(1)).astype(np.float32)
    return ((np.cross(t0, e1) * e2).sum(1) * inv).astype(np.float32)


def compare_peel(kernel_out, plain_out, label, report, pixels=None):
    """Layers and counts of the peel kernel must equal its plain version's
    (on the ``pixels`` mask when given); raises otherwise."""
    (kl, kc), (pl_, pc) = kernel_out, plain_out
    if pixels is not None:
        kl, kc, pl_, pc = kl[pixels], kc[pixels], pl_[pixels], pc[pixels]
    bad_l = int((kl != pl_).any(dim=-1).sum())
    bad_c = int((kc != pc).sum())
    print(f"  {label}: peel vs plain on {kc.numel()} pixels: {bad_l} differ in "
          f"layers, {bad_c} in counts; max count {int(kc.max()) if kc.numel() else 0}")
    if bad_l or bad_c:
        raise AssertionError(f"{label}: peel kernel differs from its plain version")
    entry = report[peel_kernel_name(kl.shape[-1])]
    entry["max_abs_err"] = max(entry["max_abs_err"], 0.0)


def peel_kernel_name(num_layers: int) -> str:
    """The kernel of peel.cu a call at ``num_layers`` launches."""
    from dmesh2_renderer_tpu_torch.ops.peel import LAYER_INSTANCES, MAX_WIDE_LAYERS

    if num_layers > MAX_WIDE_LAYERS:
        return "peel_deep"
    return "peel_wide" if num_layers > LAYER_INSTANCES[-1] else "peel"


def peel_generate(lr, idx, scene, num_layers, label, report, sz: Sizes,
                  may_truncate=False, work=None):
    """``LayeredRenderer.generate`` on the card, recording the peel
    wrapper's call, with the kernel's output held against its plain
    version on the same inputs (every tile; ``work`` is passed on to it).
    Raises on truncated binning unless ``may_truncate``. Returns (layers,
    counts, peel call)."""
    from dmesh2_renderer_tpu_torch import functional
    from dmesh2_renderer_tpu_torch.ops.peel import peel_layers_plain

    with captured_kernel_calls(functional, ("peel_layers",)) as calls:
        layers, counts = lr.generate(idx, *scene, num_layers)
    truncated = int(lr.last_aux[1])
    if truncated and not may_truncate:
        raise AssertionError(f"{label}: binning truncated {truncated} entries")
    args, out = calls["peel_layers"]
    compare_peel(out, peel_layers_plain(*args, work=work, group=sz.plain_peel_group),
                 f"{label} L={num_layers}", report)
    return layers, counts, calls["peel_layers"]


def phase_layered_checks(dev, sz: Sizes, report):
    from dmesh2_renderer_tpu_torch import LayeredRenderer, RasterConfig
    from dmesh2_renderer_tpu_torch.utils.meshes import orbit_cameras, tet_grid

    print(f"phase 2b: peel kernel vs plain version, tet_grid({sz.peel_res}) at "
          f"{sz.peel_hw}^2 and tet_grid(2) at {sz.peel_small_frame} (ragged); "
          "layered renderer vs the numpy brute force")
    verts, tets, faces, face_tets, tet_faces = tet_grid(sz.peel_res)
    exist = np.ones(faces.shape[0], np.int32)
    mv, proj = orbit_cameras(1)
    lr = LayeredRenderer(mv, proj, sz.peel_hw, sz.peel_hw,
                         config=RasterConfig(binning_capacity=sz.peel_capacity))
    peel_generate(lr, [0], (verts, faces, tets, face_tets, tet_faces, exist), 8,
                  f"tet_grid({sz.peel_res}) {sz.peel_hw}^2", report, sz,
                  may_truncate=True)
    print(f"  (binning of that config: num_rendered={int(lr.last_aux[0])}, "
          f"num_truncated={int(lr.last_aux[1])})")

    verts, tets, faces, face_tets, tet_faces = tet_grid(2)
    exist = np.ones(faces.shape[0], np.int32)
    exist[::3] = 0
    mv, proj = orbit_cameras(2)
    w, h = sz.peel_small_frame
    lr = LayeredRenderer(mv, proj, w, h, config=RasterConfig(binning_capacity=1 << 13))
    scene = (verts, faces, tets, face_tets, tet_faces, exist)
    pixels = [(y, x) for y in range(h) for x in range(w)]
    ray_d = lr.ray_d.cpu().numpy()
    ray_o = lr.ray_o[:, 0, 0].cpu().numpy()
    for num_layers in sz.peel_small_layers:
        layers, counts, _ = peel_generate(lr, [0, 1], scene, num_layers,
                                          f"tet_grid(2) {w}x{h}", report, sz)
        layers, counts = layers.cpu().numpy(), counts.cpu().numpy()
        for view in range(2):
            ref_l, ref_c, _ = brute_force_layers(verts, faces, exist, ray_o[view],
                                                 ray_d[view], num_layers, pixels)
            bad = ((layers[view].reshape(-1, num_layers) != ref_l).any(axis=1)
                   | (counts[view].reshape(-1) != ref_c))
            print(f"  LayeredRenderer vs brute force, L={num_layers}, view {view}: "
                  f"{int(bad.sum())} of {bad.size} pixels differ")
            if not bad.mean() < 0.01 or counts.max() == 0:
                raise AssertionError("LayeredRenderer differs from the brute force")


def phase_peel_ties(dev, report):
    """The peel's tie rules on one 16x16 tile of 260 entries in id order
    (128-entry blocks 0-127, 128-255, 256-259), centre ray along -z: faces
    5 and 130 share a vertex triple (t = 2.8), a tie across blocks, so the
    later goes after the earlier; face 257 (t = 2.3, block 2) displaces 5,
    which is carried past 130, its tie. Layers [257, 130, 5] (a stable merge
    would give [257, 5, 130]), by the kernel at 3, 16, 17, 32 and 97 slots."""
    from dmesh2_renderer_tpu_torch.ops.peel import peel_layers, peel_layers_plain

    f = 260
    tri = np.array([[-1.0, -1.0, 0.2], [1.0, -1.0, 0.2], [0.0, 1.0, 0.2]], np.float32)
    verts = np.tile(tri, (f, 1))
    verts[3 * 257:3 * 258] = tri + [0, 0, 0.5]
    faces = np.arange(3 * f, dtype=np.int32).reshape(f, 3)
    faces[130] = faces[5]
    exist = np.zeros(f, np.int32)
    exist[[5, 130, 257]] = 1
    entry_bf = np.full(384, f, np.int32)
    entry_bf[:f] = np.arange(f)
    ray_d = np.zeros((1, 16, 16, 3), np.float32)
    ray_d[..., 2] = -1.0
    args = [torch.as_tensor(x, device=dev) for x in (
        entry_bf, faces, verts, exist, np.array([0], np.int32),
        np.array([f], np.int32), np.array([[0.0, 0.0, 3.0]], np.float32), ray_d)]
    for num_layers in (3, 16, 17, 32, 97):
        out = peel_layers(*args, 16, 16, num_layers)
        got = out[0][0, 8, 8].tolist()
        compare_peel(out, peel_layers_plain(*args, 16, 16, num_layers),
                     f"tie scene L={num_layers}", report)
        if got[:4] != [257, 130, 5, -1][:min(4, num_layers)]:
            raise AssertionError(f"tie scene L={num_layers}: centre layers {got[:4]}")


def phase_peel_adversarial(dev, sz: Sizes, report):
    """The peel kernel against its plain version, every tile, on views that
    stress the skip rule: eyes inside the grid and on
    its planes (faces edge-on, grazing rays, faces across the camera plane),
    a ragged frame, ``sz.adv_layers`` layers (every instance: register, wide,
    deep), and rays scaled off unit length."""
    from dmesh2_renderer_tpu_torch import LayeredRenderer, RasterConfig
    from dmesh2_renderer_tpu_torch.ops.peel import (
        LAYER_INSTANCES, peel_layers, peel_layers_plain)
    from dmesh2_renderer_tpu_torch.utils.meshes import look_at, perspective, tet_grid

    w, h = sz.adv_frame
    step = 2.4 / sz.adv_res
    # Inside, on the planes x, y and z of grid lines 7, 4 and 6; inside, off
    # every plane; outside, on the planes y and z of lines 8 and 6, looking
    # along both.
    eyes = ((-1.2 + 7 * step, -1.2 + 4 * step, -1.2 + 6 * step),
            (-0.47, 0.31, 0.13), (2.5, -1.2 + 8 * step, -1.2 + 6 * step))
    targets = ((1.0, 0.3, -0.7), (-1.0, -0.2, 0.9), (0.0, -1.2 + 8 * step, 0.0))
    verts, tets, faces, face_tets, tet_faces = tet_grid(sz.adv_res)
    exist = (np.random.default_rng(5).uniform(size=faces.shape[0]) < 0.5).astype(np.int32)
    mv = np.stack([look_at(e, c) for e, c in zip(eyes, targets)])
    proj = np.stack([perspective(70.0, w / h)] * len(eyes))
    print(f"phase 2d: peel kernel vs plain version on every tile, adversarial "
          f"views of tet_grid({sz.adv_res}) ({faces.shape[0]} faces, "
          f"{int(exist.sum())} existing), ragged {w}x{h}, L in {sz.adv_layers}")
    lr = LayeredRenderer(mv, proj, w, h, config=RasterConfig(
        binning_capacity=sz.adv_capacity, max_tiles_per_face=64,
        num_giant_faces=4096))
    scene = (verts, faces, tets, face_tets, tet_faces, exist)
    idx = list(range(len(eyes)))
    phase_peel_ties(dev, report)
    calls = {}
    for num_layers in sz.adv_layers:
        work = {}
        _, counts, calls[num_layers] = peel_generate(
            lr, idx, scene, num_layers, "adversarial", report, sz, may_truncate=True,
            work=work)
        print(f"    binning num_rendered={int(lr.last_aux[0])} num_truncated="
              f"{int(lr.last_aux[1])}; pixels with a layer {int((counts > 0).sum())}, "
              f"with more than 16 {int((counts > 16).sum())}; plain version's work "
              f"{work_counts(work)}")
        if num_layers > LAYER_INSTANCES[-1]:
            tiers, over, lists = tier_use(counts, work, num_layers)
            print(f"    {peel_kernel_name(num_layers)}, tiers {tiers}: {over} pixels past "
                  f"the slot tier, {lists} block lists past the list tier")
        if int(counts.max()) < min(num_layers, 2):
            raise AssertionError("adversarial scene gives too few layers")
    # Rays off unit length, in the largest register instance and the wide one.
    for num_layers in sz.adv_ray_layers:
        if num_layers not in calls:
            continue
        args = list(calls[num_layers][0])
        for scale in sz.adv_ray_scales:
            args[7] = calls[num_layers][0][7] * scale
            compare_peel(peel_layers(*args),
                         peel_layers_plain(*args, group=sz.plain_peel_group),
                         f"adversarial L={num_layers}, rays x {scale}", report)


def tie_pairs_across_blocks(args, faces, duplicates):
    """Pairs (face, its listed-again copy) of the sheet stack that one tile's
    list holds in two different 128-entry blocks, counted over the tiles of
    the peel call ``args``."""
    entry_bf, starts, counts = (x.cpu().numpy() for x in (args[0], args[4], args[5]))
    sheet = faces[:, 0] // 4
    pairs = [(ids[0], ids[2]) for ids in (np.nonzero(sheet == d)[0] for d in duplicates)]
    pairs += [(ids[1], ids[3]) for ids in (np.nonzero(sheet == d)[0] for d in duplicates)]
    n = 0
    for start, count in zip(starts, counts):
        ids = entry_bf[start:start + count]
        for a, b in pairs:
            pa, pb = np.nonzero(ids == a)[0], np.nonzero(ids == b)[0]
            n += int(len(pa) > 0 and len(pb) > 0
                     and (start + pa[0]) // 128 != (start + pb[0]) // 128)
    return n


def tier_use(counts, work, num_layers):
    """The tiers of the tiered instance at ``num_layers`` (> 16) and how far
    a peel's pixels pass them: the pixels with more slots than the slot
    tier, and the (pixel, 128-entry block) lists longer than the list tier
    (from the plain version's ``block_hits``, ``work``). Returns (tiers,
    pixels, lists)."""
    from dmesh2_renderer_tpu_torch.ops.peel import peel_tiers

    tiers = peel_tiers(num_layers)
    hits = torch.as_tensor(work["block_hits"])
    return (tiers, int((counts > tiers["slot_tier"]).sum()),
            int(hits[tiers["list_tier"] + 1:].sum()))


def reciprocal_mismatches(dev) -> int:
    """The floats on which the deep peel's branch-free reciprocal
    (csrc/peel.cu, rcp_of_in_range) differs from 1.0f / x in any bit:
    peel_rcp_check over every float32 bit pattern of its range."""
    import ctypes

    from dmesh2_renderer_tpu_torch.ops import _kernels

    fn = _kernels.PEEL.load().peel_rcp_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    _kernels.PEEL.check(fn(ctypes.c_void_p(bad.data_ptr()), _kernels.current_stream(dev)),
                        "peel_rcp_check")
    return int(bad)


def phase_peel_deep(dev, sz: Sizes, report):
    """The peel above 16 layers (the tiered instances: wide up to 96, deep
    above) against its plain version on every tile of the sheet stack, at
    ``sz.deep_layers``; every ray has more hits than that, so counts reach L
    and pass the slot tier, block lists pass the list tier, exact t ties lie
    across blocks, and the half tiles outnumber the persistent grid's
    blocks. Then smaller sheets (``sz.deep_ring_half_size``), whose edges
    cross the frame: counts fall from L at the centre, and warps hold pixels
    on both sides of the slot tier. First the deep instance's branch-free
    reciprocal against 1.0f / x. Returns the plain version's and the
    kernel's times on the first scene at the largest L."""
    from dmesh2_renderer_tpu_torch import LayeredRenderer, RasterConfig
    from dmesh2_renderer_tpu_torch.ops.peel import (
        MAX_WIDE_LAYERS, peel_layers, peel_layers_plain, tiered_grid)
    from dmesh2_renderer_tpu_torch.utils.meshes import look_at, perspective, sheet_stack

    w, h = sz.deep_frame
    duplicates = (20, 62, 125)
    mv = look_at((0.0, 0.0, 3.0), (0.0, 0.0, 0.0))[None]
    proj = perspective(60.0, w / h)[None]
    lr = LayeredRenderer(mv, proj, w, h, config=RasterConfig(
        binning_capacity=sz.deep_capacity, max_tiles_per_face=64, num_giant_faces=512))
    # Exponent fields 0, 253, 254 and 255 of either sign are out of range.
    in_range = (1 << 32) - 8 * (1 << 23)
    bad = reciprocal_mismatches(dev)
    print(f"phase 2d (tiered): the tiered instances' branch-free 1/det differs from "
          f"1.0f / x on {bad} of the {in_range} floats of its range")
    if bad:
        raise AssertionError("the tiered peel's reciprocal differs from 1.0f / x")
    out = {}
    for half_size in (sz.deep_half_size, sz.deep_ring_half_size):
        verts, faces = sheet_stack(half_size=half_size, duplicates=duplicates)
        f = faces.shape[0]
        ring = half_size != sz.deep_half_size
        print(f"phase 2d (tiered): peel kernel vs plain version on every tile, sheet "
              f"stack ({f} faces: 150 sheets of half size {half_size}, {duplicates} "
              f"listed twice), {w}x{h}, L in {sz.deep_layers}")
        scene = (verts, faces, np.zeros((1, 4), np.int32), np.full((f, 2), -1, np.int32),
                 np.zeros((1, 4), np.int32), np.ones(f, np.int32))
        for num_layers in sz.deep_layers:
            work = {}
            _, counts, (args, _) = peel_generate(lr, [0], scene, num_layers,
                                                 "sheet stack", report, sz, work=work)
            crossing = tie_pairs_across_blocks(args, faces, duplicates)
            units = 2 * args[4].shape[0]
            grid = tiered_grid(dev.index, num_layers > MAX_WIDE_LAYERS)
            tiers, over, lists = tier_use(counts, work, num_layers)
            # warps: two tile rows of 16 pixels (the frame is a multiple of 16)
            warps = (counts > tiers["slot_tier"]).reshape(h // 2, 2, w // 16, 16)
            mixed = int((warps.any(3).any(1) & ~warps.all(3).all(1)).sum())
            print(f"    binning num_rendered={int(lr.last_aux[0])} num_truncated="
                  f"{int(lr.last_aux[1])}; counts min {int(counts.min())} max "
                  f"{int(counts.max())}; tied pairs across 128-entry blocks {crossing}; "
                  f"{units} half-tile units over {peel_kernel_name(num_layers)}'s "
                  f"persistent grid of {min(units, grid)} blocks; tiers {tiers}: {over} "
                  f"pixels past the slot tier, {mixed} warps on both sides of it, {lists} "
                  "block lists past the list tier")
            if ((int(counts.min()) != num_layers and not ring) or crossing == 0
                    or units <= grid or over == 0 or lists == 0 or (ring and mixed == 0)):
                raise AssertionError(
                    f"sheet stack at L={num_layers}: counts {int(counts.min())}-"
                    f"{int(counts.max())}, {crossing} tied pairs across blocks, {units} "
                    f"units, grid {grid}, {over} pixels and {lists} lists past the "
                    f"tiers, {mixed} warps on both sides")
        if not ring:
            plain_ms, _ = timed_once(lambda: peel_layers_plain(
                *args, group=sz.plain_peel_group))
            ms, _ = time_ms(lambda: peel_layers(*args), sz.reps)
            print(f"    at L={sz.deep_layers[-1]}: kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms")
            out.update(plain_ms=plain_ms, ms=ms,
                       inputs=f"sheet stack {w}x{h}, L={sz.deep_layers[-1]}, every tile")
    return out


def layered_scene(sz: Sizes):
    from dmesh2_renderer_tpu_torch import RasterConfig
    from dmesh2_renderer_tpu_torch.utils.meshes import orbit_cameras, tet_grid

    verts, tets, faces, face_tets, tet_faces = tet_grid(sz.layered_res)
    exist = (np.random.default_rng(3).uniform(size=faces.shape[0])
             < sz.layered_exist_frac).astype(np.int32)
    mv, proj = orbit_cameras(sz.layered_views)
    config = RasterConfig(binning_capacity=sz.layered_capacity,
                          max_tiles_per_face=sz.layered_max_tiles,
                          num_giant_faces=sz.layered_giant_faces,
                          giant_tiles=sz.layered_giant_tiles)
    return (verts, faces, tets, face_tets, tet_faces, exist), mv, proj, config


def phase_layered_main(dev, sz: Sizes, report, kernels):
    """The layered main path: one LayeredRenderer.generate at full size."""
    from dmesh2_renderer_tpu_torch import LayeredRenderer
    from dmesh2_renderer_tpu_torch.ops.peel import peel_layers, peel_layers_plain

    scene, mv, proj, config = layered_scene(sz)
    verts, faces, exist = scene[0], scene[1], scene[5]
    n_views, w, h, n_layers = sz.layered_views, sz.width, sz.height, sz.layered_layers
    print(f"phase 5: layered main path, LayeredRenderer.generate on "
          f"tet_grid({sz.layered_res}) ({verts.shape[0]} vertices, "
          f"{faces.shape[0]} faces, {int(exist.sum())} existing), {n_views} views at "
          f"{w}x{h}, {n_layers} layers")
    lr = LayeredRenderer(mv, proj, w, h, config=config)
    idx = list(range(n_views))
    scene_t = tuple(torch.as_tensor(x, device=dev) for x in scene)
    reset_launches(kernels)
    work = {}
    layers, counts, peel_call = peel_generate(lr, idx, scene_t, n_layers,
                                              f"main {w}x{h}", report, sz, work=work)
    launches = read_launches(kernels)
    nr, nt = (int(x) for x in lr.last_aux)
    print(f"  launches on the layered path: {launches}")
    print(f"  aux: num_rendered={nr} num_truncated={nt}")
    record_launches(report, launches, LAYERED_KERNELS, "layered")
    if tuple(layers.shape) != (n_views, h, w, n_layers) or nt != 0:
        raise AssertionError(f"layered output {tuple(layers.shape)}, truncated {nt}")
    cmax = int(counts.max())
    exist_t = torch.as_tensor(exist, device=dev)
    slot = torch.arange(n_layers, device=dev)
    ids_ok = torch.where(layers >= 0, exist_t[layers.clamp(min=0).long()] > 0,
                         layers == -1).all()
    prefix_ok = ((layers >= 0) == (slot < counts[..., None])).all()
    covered = int((counts > 0).sum())
    print(f"  counts.max() {cmax}; pixels with a layer {covered} of {counts.numel()}; "
          f"ids existing or -1: {bool(ids_ok)}; layers a -1-padded prefix: {bool(prefix_ok)}")
    if cmax != n_layers or not bool(ids_ok) or not bool(prefix_ok):
        raise AssertionError("layered output fails its contract")

    # Sampled pixels vs the numpy brute force on the port's own rays, and
    # the t of their layers recomputed: non-decreasing.
    rng = np.random.default_rng(11)
    cnt_np = counts.cpu().numpy()
    hit_pix = np.argwhere(cnt_np > 0)
    sample = hit_pix[rng.choice(len(hit_pix), sz.layered_pixels, replace=False)]
    sample = np.concatenate([sample, np.stack([
        rng.integers(0, n_views, 8), rng.integers(0, h, 8), rng.integers(0, w, 8)], 1)])
    lay_np = layers.cpu().numpy()
    ray_o = lr.ray_o[:, 0, 0].cpu().numpy()
    ties = bad = 0
    for view in range(n_views):
        pix = sample[sample[:, 0] == view][:, 1:]
        ray_d = lr.ray_d[view][tuple(torch.as_tensor(pix.T, device=dev))].cpu().numpy()
        ref_l, ref_c, tie = brute_force_layers(
            verts, faces, exist, ray_o[view], ray_d[:, None, :], n_layers,
            [(i, 0) for i in range(len(pix))])
        for i, (y, x) in enumerate(pix):
            got = lay_np[view, y, x]
            if not (np.array_equal(got, ref_l[i]) and cnt_np[view, y, x] == ref_c[i]):
                ties += int(tie[i])
                bad += int(not tie[i])
            ids = got[got >= 0]
            if len(ids) and not (np.diff(ray_t(verts, faces, ray_o[view], ray_d[i],
                                               ids)) >= 0).all():
                raise AssertionError(f"layers of pixel {(view, y, x)} are not in t order")
    print(f"  {len(sample)} sampled pixels vs the brute force: {bad} differ, "
          f"{ties} more differ at an exact t tie; layer t non-decreasing")
    if bad:
        raise AssertionError("layered output differs from the brute force")

    # The kernel vs its plain version on every sz.layered_tile_stride-th
    # tile, and the kernel restricted to those tiles vs its full run.
    args = peel_call[0]
    n_tiles = args[4].shape[0]
    tiles = torch.arange(0, n_tiles, sz.layered_tile_stride, dtype=torch.int32,
                         device=dev)
    mask = torch.zeros(n_tiles, dtype=torch.bool, device=dev)
    mask[tiles.long()] = True
    gx, gy = -(-w // 16), -(-h // 16)
    mask = (mask.reshape(n_views, gy, gx).repeat_interleave(16, 1)
            .repeat_interleave(16, 2)[:, :h, :w])
    plain = peel_layers_plain(*args, tiles=tiles)
    compare_peel(peel_call[1], plain, f"main {w}x{h}, {tiles.numel()} sampled tiles",
                 report, pixels=mask)
    sub = peel_layers(*args, tiles=tiles)
    compare_peel(sub, plain, f"main {w}x{h}, kernel on the sampled tiles only",
                 report)
    return lr, scene_t, idx, peel_call, tiles, mask, work


def work_counts(work):
    """The plain peel's scalar work counts (``work`` less its histogram)."""
    return {k: int(v) for k, v in work.items() if k != "block_hits"}


def peel_bound(args, work, tiles=None, pixels=None):
    """Least time for the peel of these inputs (``work`` from the plain
    version): entry_bf of every walked entry, the face tables, the tile
    ranges and rays read once, layers and counts written once; against the
    per-entry, per-pair and per-hit float operations of csrc/peel.cu (one
    per-hit charge for every L). Two bounds: the full scan (every pair, the
    JAX kernel's work; entries, pairs and hits do not depend on L, so
    neither does its operation count) and the work left after the kernel's
    skip rule at the L ``work`` was counted at (the skip bound per entry,
    one comparison per skipped pair). With ``tiles`` (and ``pixels``, the
    count of their pixels in the frame), for the peel of those tiles alone.

    Returns (full-scan ms, its limit, after-skip ms, its limit, counts)."""
    from dmesh2_renderer_tpu_torch.ops.peel import (
        OPS_PER_ENTRY, OPS_PER_ENTRY_BOUND, OPS_PER_HIT, OPS_PER_PAIR,
        OPS_PER_SKIPPED_PAIR)

    _, faces, verts, exist, starts, counts, ray_o, ray_d, _, _, n_layers = args
    w = work_counts(work)
    if tiles is not None:
        counts = counts[tiles.long()]
    n_pix = ray_d.numel() // 3 if pixels is None else pixels
    nbytes = (int(counts.sum()) * 4 + faces.numel() * 4 + verts.numel() * 4
              + exist.numel() * 4 + 2 * counts.numel() * 4
              + ray_o.numel() * 4 + n_pix * 3 * 4 + n_pix * (n_layers + 1) * 4)
    hit_ops = w["hits"] * OPS_PER_HIT
    ops = w["entries"] * OPS_PER_ENTRY + w["pairs"] * OPS_PER_PAIR + hit_ops
    ops_left = (w["entries"] * (OPS_PER_ENTRY + OPS_PER_ENTRY_BOUND)
                + (w["pairs"] - w["skipped"]) * OPS_PER_PAIR
                + w["skipped"] * OPS_PER_SKIPPED_PAIR + hit_ops)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3

    def bound(n_ops):
        t_ops = n_ops / FP32_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    return (*bound(ops), *bound(ops_left),
            dict(w, bytes=nbytes, ops=ops, ops_after_skip=ops_left))


def phase_layered_timing(dev, sz: Sizes, report, lr, scene, idx, peel_call, tiles,
                         work):
    from dmesh2_renderer_tpu_torch import geometry as G
    from dmesh2_renderer_tpu_torch.ops.binning import bin_faces
    from dmesh2_renderer_tpu_torch.ops.peel import (
        pack_peel_stream, peel_layers, peel_layers_plain)
    from dmesh2_renderer_tpu_torch.ops.reference import face_depth01

    w, h, n_layers = sz.width, sz.height, sz.layered_layers
    n_pix = len(idx) * w * h
    print(f"phase 6: layered timing (median of {sz.reps} after warm-up)")
    gen_ms, gen_all = time_ms(lambda: lr.generate(idx, *scene, n_layers), sz.reps,
                              warmup=2)
    mpix = n_pix / (gen_ms * 1e3)
    print(f"  LayeredRenderer.generate, {len(idx)} views at {w}x{h}, L={n_layers}: "
          f"{gen_ms:.3f} ms ({mpix:.2f} Mpix/s); runs {[round(t, 3) for t in gen_all]}")

    args = peel_call[0]
    entry_bf, faces, verts, exist = args[:4]
    peel_ms, _ = time_ms(lambda: peel_layers(*args), sz.reps)
    sub_ms, _ = time_ms(lambda: peel_layers(*args, tiles=tiles), sz.reps)
    sub_plain_ms, _ = time_ms(lambda: peel_layers_plain(*args, tiles=tiles), 1)
    plain_ms, _ = time_ms(lambda: peel_layers_plain(*args, group=sz.plain_peel_group),
                          1, warmup=0)
    bound, bound_by, left, left_by, peel_work = peel_bound(args, work)
    report["peel"].update(ms=peel_ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=bound_by, library_ms=None)
    pairs, hits = peel_work["pairs"], peel_work["hits"]
    print(f"  peel: {peel_ms:.3f} ms, plain {plain_ms:.3f} ms, full-scan bound "
          f"{bound:.3f} ms ({bound_by}), after-skip bound {left:.3f} ms ({left_by}); "
          f"skipped {peel_work['skipped'] / pairs:.1%} of {pairs} pairs, gated "
          f"{peel_work['gated'] / hits:.1%} of {hits} hits ({peel_work}); on the "
          f"{tiles.numel()} sampled tiles: kernel {sub_ms:.3f} ms, plain "
          f"{sub_plain_ms:.3f} ms")

    # Where generate's time goes: each stage at the main path's inputs.
    b_mv, b_proj = lr.mv[idx], lr.proj[idx]
    vndc, vimg = G.compute_verts_ndc_image(verts, b_mv, b_proj, w, h)
    tris = G.face_aa_verts_ccw(vimg, faces)
    _, min_depth, _, alive = face_depth01(vndc, faces)
    config = lr.config
    pm = torch.zeros((len(idx), 2), dtype=torch.int32, device=dev)

    def binning():
        return bin_faces(tris, min_depth, alive, pm, w, h, config.binning_capacity,
                         config.max_tiles_per_face,
                         num_giant_faces=config.num_giant_faces,
                         giant_tiles=config.giant_tiles)

    stages = {
        "project_triangles": time_ms(lambda: G.face_aa_verts_ccw(
            G.compute_verts_ndc_image(verts, b_mv, b_proj, w, h)[1], faces), sz.reps)[0],
        "depth_cull": time_ms(lambda: face_depth01(vndc, faces), sz.reps)[0],
        "bin_faces": time_ms(binning, sz.reps)[0],
        "peel": peel_ms,
    }
    stages["rest_of_generate"] = gen_ms - sum(stages.values())
    pack_ms, _ = time_ms(lambda: pack_peel_stream(entry_bf, verts, faces, exist),
                         sz.reps)
    peel_work["block_hits"] = work["block_hits"].tolist()
    print("  stages (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"  [the peel gathers its face records inside the kernel; the plain "
          f"version's (R, 16) table, pack_peel_stream, would take {pack_ms:.3f} ms]")
    return dict(generate_ms=gen_ms, generate_runs_ms=gen_all, generate_mpix_per_s=mpix,
                layered_stages_ms=stages, peel_pack_ms=pack_ms, peel_work=peel_work,
                peel_bound_after_skip_ms=left,
                peel_sampled_tiles=tiles.numel(), peel_sampled_ms=sub_ms,
                peel_sampled_plain_ms=sub_plain_ms)


def phase_sharded_peel(dev, sz: Sizes, report, kernels, lr, scene, tiles, mask,
                       peel_work):
    """generate_layers_sharded on a world of one at L = sz.sharded_layers on
    the layered headline, bit for bit equal to functional.generate_layers;
    the kernel (its wide instance) against its plain version on the sampled
    tiles (``tiles``, their pixels ``mask``), its time beside the full-scan
    bound, and the kernel's time on those tiles beside the plain version's
    and beside the after-skip bound of those tiles at that L (from the plain
    version's work counts there); its resources (it must not spill). Then
    the wide instance built with the deep instance's tiers at
    ``sz.deep_tier_layers`` and with the tiers of ``sz.wide_tier_sweep`` at
    ``sz.wide_sweep_layers``, each equal to the package's kernel and timed
    on the same inputs."""
    from dmesh2_renderer_tpu_torch import functional
    from dmesh2_renderer_tpu_torch.ops.peel import (
        LAYER_INSTANCES, peel_layers, peel_layers_plain, peel_tiers, tiered_grid,
        wide_occupancy)
    from dmesh2_renderer_tpu_torch.parallel import generate_layers_sharded, make_view_mesh

    n_layers, w, h = sz.sharded_layers, sz.width, sz.height
    verts, faces, exist = scene[0], scene[1], scene[5]
    mv, proj, config = lr.mv, lr.proj, lr.config
    print(f"phase 6b: generate_layers_sharded, world of one, layered headline "
          f"({mv.shape[0]} views at {w}x{h}), L={n_layers}")
    mesh = make_view_mesh()
    reset_launches(kernels)
    with captured_kernel_calls(functional, ("peel_layers",)) as calls:
        layers, counts, (nr, nt) = generate_layers_sharded(
            mesh, verts, faces, exist, mv, proj, w, h, n_layers, config)
    launches = read_launches(kernels)
    print(f"  launches on the sharded peel path: {launches}")
    record_launches(report, launches, SHARDED_KERNELS, "sharded peel")
    ref = functional.generate_layers(verts, faces, exist, mv, proj, w, h, n_layers,
                                     config)
    same = (torch.equal(layers, ref[0]) and torch.equal(counts, ref[1])
            and (int(nr), int(nt)) == (int(ref[2][0]), int(ref[2][1])))
    print(f"  equal to functional.generate_layers bit for bit: {same}; "
          f"num_rendered={int(nr)} num_truncated={int(nt)}; counts.max() "
          f"{int(counts.max())}; pixels with more than 16 layers "
          f"{int((counts > 16).sum())}")
    if not same or int(nt) != 0:
        raise AssertionError("generate_layers_sharded differs from generate_layers")
    args = calls["peel_layers"][0]
    n_tiles = args[4].shape[0]
    plain_ms, plain = timed_once(lambda: peel_layers_plain(*args, tiles=tiles))
    compare_peel(calls["peel_layers"][1], plain,
                 f"L={n_layers} {w}x{h}, {tiles.numel()} sampled tiles", report,
                 pixels=mask)
    del plain
    tile_work = {}
    peel_layers_plain(*args, tiles=tiles, work=tile_work)
    ms, runs = time_ms(lambda: peel_layers(*args), sz.reps)
    sub_ms, _ = time_ms(lambda: peel_layers(*args, tiles=tiles), sz.reps)
    bound, bound_by, _, _, _ = peel_bound(args, peel_work)
    _, _, sub_left, sub_left_by, sub_work = peel_bound(args, tile_work, tiles,
                                                       int(mask.sum()))
    report["peel_wide"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                               bound_by=bound_by, library_ms=None,
                               plain_tiles=f"{tiles.numel()} of {n_tiles}",
                               ms_plain_tiles=sub_ms,
                               bound_ms_after_skip_plain_tiles=sub_left)
    occ = dict(wide_occupancy(n_layers), grid=min(2 * n_tiles, tiered_grid(dev.index, False)))
    tiers = peel_tiers(n_layers)
    occ["scratch_bytes"] = occ["grid"] * tiers["scratch_bytes"]
    print(f"  peel_wide at L={n_layers}: {ms:.3f} ms (runs {[round(t, 3) for t in runs]}), "
          f"full-scan bound {bound:.3f} ms ({bound_by}); on the "
          f"{tiles.numel()} sampled tiles: kernel {sub_ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"after-skip bound at L={n_layers} {sub_left:.4f} ms ({sub_left_by}; "
          f"{sub_work}); wide instance {occ}, tiers {tiers}")
    if occ["local_bytes"]:
        raise AssertionError(f"the wide instance spills: {occ}")

    # The wide instance with the deep instance's tiers (the deep launch
    # taking every L above the register instances), and with other tiers of
    # its own.
    as_deep = peel_variants(args, {"deep tiers": {"kMaxWideLayers": LAYER_INSTANCES[-1]}},
                          sz.deep_tier_layers, sz.reps)
    sweep = peel_variants(args, {
        key: {"kWideSlotTier": key[0], "kWideListTier": key[1]}
        for key in sz.wide_tier_sweep}, sz.wide_sweep_layers, sz.reps)
    for title, result in (("with the deep instance's tiers", as_deep),
                          ("with other (slot, list) tiers", sweep)):
        print(f"  the wide instance {title} on the same inputs, ms (blocks per SM):")
        for key, by_l in result.items():
            print(f"    {key}: " + ", ".join(
                f"L={n} {r['ms']:.3f} ({r['blocks_per_sm']})" for n, r in by_l.items()))
    bad = [(key, n) for result in (as_deep, sweep) for key, by_l in result.items()
           for n, r in by_l.items() if not r["equal"]]
    if bad:
        raise AssertionError(f"peel.cu variants differ from the package's kernel: {bad}")
    return dict(peel_sharded_layers=n_layers, peel_wide_ms=ms, peel_wide_runs_ms=runs,
                peel_wide_bound_ms=bound, peel_wide_resources=occ, peel_wide_tiers=tiers,
                peel_wide_sampled_ms=sub_ms, peel_wide_sampled_plain_ms=plain_ms,
                peel_wide_sampled_after_skip_bound_ms=sub_left,
                peel_wide_sampled_work=sub_work,
                peel_wide_deep_tiers={k: {str(n): r for n, r in v.items()}
                                      for k, v in as_deep.items()},
                peel_wide_tier_sweep={str(k): {str(n): r for n, r in v.items()}
                                      for k, v in sweep.items()})


@contextlib.contextmanager
def peel_built_from(kernel, max_wide=None):
    """ops/peel.py's wrapper launching the instances of ``kernel`` (a build
    of another copy of csrc/peel.cu) and, if ``max_wide`` is given, taking
    the deep instance above that many layers (the copy's kMaxWideLayers)."""
    from dmesh2_renderer_tpu_torch.ops import _kernels, peel

    saved = _kernels.PEEL, _kernels.PEEL_WIDE, _kernels.PEEL_DEEP, peel.MAX_WIDE_LAYERS
    try:
        _kernels.PEEL = kernel
        _kernels.PEEL_WIDE, _kernels.PEEL_DEEP = (
            _kernels.Instance(i.name, kernel, i.launch, i.argtypes) for i in saved[1:3])
        if max_wide is not None:
            peel.MAX_WIDE_LAYERS = max_wide
        peel.tiered_grid.cache_clear()
        yield
    finally:
        _kernels.PEEL, _kernels.PEEL_WIDE, _kernels.PEEL_DEEP, peel.MAX_WIDE_LAYERS = saved
        peel.tiered_grid.cache_clear()


def peel_variants(args, variants, layer_counts, reps):
    """csrc/peel.cu built with other values of its named constants (a copy
    under the build directory per variant, ``{label: {name: value}}``, all
    nvcc runs at once; a variant that sets kMaxWideLayers also moves the
    wrapper's switch to the deep instance), run on the peel call ``args`` at
    each of ``layer_counts`` layers: each variant's layers and counts
    compared with the package's kernel there, and each timed. Returns
    {label: {L: {ms, blocks_per_sm, equal}}}, the package's kernel under the
    label "package"."""
    import re
    from concurrent.futures import ThreadPoolExecutor

    from dmesh2_renderer_tpu_torch.ops import _kernels, peel

    source = _kernels.PEEL.source.read_text()
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    kernels = {}
    for label, constants in variants.items():
        text = source
        for name, value in constants.items():
            text, n = re.subn(rf"\b{name} = \d+;", f"{name} = {value};", text)
            if n != 1:
                raise ValueError(f"csrc/peel.cu sets {name} {n} times, not once")
        path = _kernels.BUILD_DIR / ("peel_" + "_".join(
            f"{name}{value}" for name, value in constants.items()) + ".cu")
        path.write_text(text)
        kernels[label] = _kernels.Kernel(
            "peel", str(path), _kernels.PEEL.argtypes,
            extra_flags=_kernels.PEEL.flags[len(_kernels.NVCC_FLAGS):])
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(_kernels.Kernel.build, kernels.values()))

    def run(n):
        return peel.peel_layers(*args[:-1], n)

    def measure(n, want=None):
        occ = (peel.deep_occupancy() if n > peel.MAX_WIDE_LAYERS
               else peel.wide_occupancy(n))
        got = run(n)
        return dict(ms=time_ms(lambda: run(n), reps)[0], blocks_per_sm=occ["blocks_per_sm"],
                    equal=want is None or all(torch.equal(a, b) for a, b in zip(got, want)))

    want = {n: run(n) for n in layer_counts}
    out = {"package": {n: measure(n) for n in layer_counts}}
    for label, kernel in kernels.items():
        with peel_built_from(kernel, variants[label].get("kMaxWideLayers")):
            out[label] = {n: measure(n, want[n]) for n in layer_counts}
    return out


def phase_sharded_deep_peel(dev, sz: Sizes, report, kernels, lr, scene, tiles, mask,
                            peel_work, deep, card):
    """generate_layers_sharded on a world of one at L = sz.sharded_deep_layers
    (the deep instance) on the layered headline: its first sz.sharded_layers
    layers and counts equal those of functional.generate_layers at that L
    (the prefix property), on every pixel; all its layers equal the plain
    version's on the sampled tiles (``tiles``, their pixels ``mask``); the
    kernel's time beside the full-scan bound. ``deep``: the plain version's
    and the kernel's times on the sheet stack (phase 2d)."""
    from dmesh2_renderer_tpu_torch import functional
    from dmesh2_renderer_tpu_torch.ops.peel import (
        MAX_WIDE_LAYERS, deep_occupancy, peel_layers, peel_layers_plain, tiered_grid)
    from dmesh2_renderer_tpu_torch.parallel import generate_layers_sharded, make_view_mesh

    n_layers, n_ref, w, h = sz.sharded_deep_layers, sz.sharded_layers, sz.width, sz.height
    verts, faces, exist = scene[0], scene[1], scene[5]
    mv, proj, config = lr.mv, lr.proj, lr.config
    print(f"phase 6b (deep): generate_layers_sharded, world of one, layered headline "
          f"({mv.shape[0]} views at {w}x{h}), L={n_layers}")
    reset_launches(kernels)
    with captured_kernel_calls(functional, ("peel_layers",)) as calls:
        layers, counts, (nr, nt) = generate_layers_sharded(
            make_view_mesh(), verts, faces, exist, mv, proj, w, h, n_layers, config)
    launches = read_launches(kernels)
    print(f"  launches on the deep sharded peel path: {launches}")
    record_launches(report, launches, DEEP_KERNELS, "deep sharded peel")
    ref_l, ref_c, _ = functional.generate_layers(verts, faces, exist, mv, proj, w, h,
                                                 n_ref, config)
    same = (torch.equal(layers[..., :n_ref], ref_l)
            and torch.equal(counts.clamp(max=n_ref), ref_c))
    print(f"  first {n_ref} layers equal to generate_layers at L={n_ref} on every "
          f"pixel: {same}; num_truncated={int(nt)}; counts.max() {int(counts.max())}; "
          f"pixels with more than {n_ref} layers {int((counts > n_ref).sum())}")
    if not same or int(nt) != 0:
        raise AssertionError("the deep peel's prefix differs from generate_layers")
    tiers, over, _ = tier_use(counts, peel_work, n_layers)
    hist = {n: float((counts > n).float().mean())
            for n in (16, 32, 48, 64, tiers["slot_tier"], 96)}
    print(f"  counts at L={n_layers}: share of pixels above "
          + ", ".join(f"{n} {s:.4%}" for n, s in hist.items())
          + f"; max {int(counts.max())}; past the slot tier ({tiers['slot_tier']}) "
          f"{over} pixels")
    # The block's list at L = 128 takes every hit of its 128 entries (the
    # gate keeps nothing out below 128 filled slots): its length, from the
    # plain version's histogram over every tile (phase 5).
    block_hits = torch.tensor(peel_work["block_hits"])
    lists = int(block_hits[1:].sum())
    list_hist = {n: int(block_hits[n + 1:].sum()) / lists
                 for n in (8, 16, tiers["list_tier"], 32, 48)}
    print(f"  block lists (pixel, 128-entry block) with a hit: {lists}; share longer "
          "than " + ", ".join(f"{n} {s:.4%}" for n, s in list_hist.items())
          + f"; longest {int(block_hits.nonzero().max())}")
    args = calls["peel_layers"][0]
    # Continuity: the wide instance at 96 layers and the deep one at 97, on
    # the same inputs: the first 96 layers equal (the prefix property), the
    # times near each other.
    n_wide = MAX_WIDE_LAYERS
    (l96, c96), (l97, c97) = (peel_layers(*args[:-1], n) for n in (n_wide, n_wide + 1))
    prefix = torch.equal(l97[..., :n_wide], l96) and torch.equal(c97.clamp(max=n_wide), c96)
    del l96, c96, l97, c97
    placement = {n: time_ms(lambda: peel_layers(*args[:-1], n), sz.reps)[0]
                 for n in (n_wide, n_wide + 1)}
    ratio = placement[n_wide] / placement[n_wide + 1]
    print(f"  continuity: peel_wide at L={n_wide} {placement[n_wide]:.3f} ms, peel_deep "
          f"at L={n_wide + 1} {placement[n_wide + 1]:.3f} ms ({ratio:.3f}x, within 15%: "
          f"{abs(ratio - 1) <= 0.15}); first {n_wide} layers and counts equal: {prefix}; "
          f"on {card}")
    if not prefix:
        raise AssertionError(f"the peel at L={n_wide} is not a prefix of L={n_wide + 1}")
    plain_ms, plain = timed_once(lambda: peel_layers_plain(
        *args, tiles=tiles, group=sz.plain_peel_group))
    compare_peel(calls["peel_layers"][1], plain,
                 f"L={n_layers} {w}x{h}, {tiles.numel()} sampled tiles", report,
                 pixels=mask)
    print(f"    plain version on those tiles {plain_ms:.3f} ms")
    del plain
    ms, runs = time_ms(lambda: peel_layers(*args), sz.reps)
    bound, bound_by, _, _, work = peel_bound(args, peel_work)
    report["peel_deep"].update(ms=ms, plain_ms=deep["plain_ms"], bound_ms=bound,
                               bound_by=bound_by, library_ms=None,
                               plain_inputs=deep["inputs"], ms_plain_inputs=deep["ms"])
    occ = dict(deep_occupancy(), grid=min(2 * args[4].shape[0], tiered_grid(dev.index, True)))
    occ["scratch_bytes"] = occ["grid"] * tiers["scratch_bytes"]
    print(f"  peel_deep at L={n_layers}: {ms:.3f} ms (runs {[round(t, 3) for t in runs]}), "
          f"full-scan bound {bound:.3f} ms ({bound_by}; {work['bytes']} bytes, "
          f"{work['ops']} operations); deep instance {occ}, tiers {tiers}; on {card}")
    if occ["local_bytes"] or occ["blocks_per_sm"] < 2:
        raise AssertionError(f"the deep instance spills or holds under 2 blocks per SM: {occ}")
    sweep = peel_variants(args, {
        key: {"kDeepSlotTier": key[0], "kDeepListTier": key[1]}
        for key in sz.deep_tier_sweep}, (n_layers,), sz.reps)
    bad = [key for key in sz.deep_tier_sweep if not sweep[key][n_layers]["equal"]]
    print("  the deep instance with other tiers (slots, list entries) on the same "
          "inputs: " + "; ".join(f"{key}: {r[n_layers]['blocks_per_sm']} blocks per SM, "
                                 f"{r[n_layers]['ms']:.3f} ms" for key, r in sweep.items()
                                 if key != "package")
          + f"; the package's ({tiers['slot_tier']}, {tiers['list_tier']}): "
          f"{occ['blocks_per_sm']} blocks per SM, {ms:.3f} ms")
    if bad:
        raise AssertionError(f"the deep peel with tiers {bad} differs")
    sweep = {key: (r[n_layers]["ms"], r[n_layers]["blocks_per_sm"])
             for key, r in sweep.items() if key != "package"}
    return dict(peel_deep_layers=n_layers, peel_deep_ms=ms, peel_deep_runs_ms=runs,
                peel_deep_bound_ms=bound, peel_deep_resources=occ,
                peel_deep_sheet_stack=deep, peel_deep_counts_above=hist,
                peel_deep_lists_longer=list_hist, peel_placement_ms=placement,
                peel_deep_tier_sweep={f"{a},{b}": v for (a, b), v in sweep.items()})


def config5_scene(sz: Sizes):
    """The JAX package's BASELINE.json config 5 (benchmarks/run.py:167-211):
    icosphere(3), sz.trainer_views orbit cameras at sz.trainer_res^2,
    colours |verts| mod 1, opacity 0.5, unit intensities, black targets and
    background."""
    from dmesh2_renderer_tpu_torch.parallel import SceneParams
    from dmesh2_renderer_tpu_torch.utils.meshes import icosphere, orbit_cameras

    verts, faces = icosphere(sz.trainer_subdiv)
    mv, proj = orbit_cameras(sz.trainer_views)
    f, b, r = faces.shape[0], sz.trainer_views, sz.trainer_res
    params = SceneParams(verts, np.abs(verts) % 1.0, np.full((f,), 0.5, np.float32))
    batch = (np.ones((b, f), np.float32), mv, proj,
             np.zeros((b, r, r, 3), np.float32), np.zeros(3, np.float32))
    return params, faces, batch


def phase_trainer(dev, sz: Sizes, report, kernels, card):
    """The Trainer at config 5 on a world of one: the loss falls, the three
    renderer kernels launch and, in the first step, agree with their plain
    versions on the inputs the Trainer gave them, a checkpoint round-trips
    exactly, and the steady-state time per step."""
    import functools
    import tempfile

    from dmesh2_renderer_tpu_torch import RasterConfig
    from dmesh2_renderer_tpu_torch.parallel import make_view_mesh
    from dmesh2_renderer_tpu_torch.train import Trainer, save_checkpoint

    params, faces, batch = config5_scene(sz)
    r = sz.trainer_res
    print(f"phase 6c: Trainer, config 5: icosphere({sz.trainer_subdiv}) "
          f"({faces.shape[0]} faces), {sz.trainer_views} views at {r}x{r}, Adam 1e-2, "
          f"binning_capacity {sz.trainer_capacity}, world of one")
    mesh = make_view_mesh()
    opt = functools.partial(torch.optim.Adam, lr=1e-2)
    config = RasterConfig(binning_capacity=sz.trainer_capacity)
    tr = Trainer(mesh, opt, faces, r, r, 1.0, config)
    state = tr.init_state(params)
    batch = tuple(torch.as_tensor(x, device=dev) for x in batch)
    losses = []
    reset_launches(kernels)
    with captured_kernel_calls(copy=True) as calls:  # warm-up; the first step
        state, loss = tr.step(state, *batch)
    losses.append(float(loss))
    state, loss = tr.step(state, *batch)
    losses.append(float(loss))
    launches = read_launches(kernels)
    print(f"  launches in the two warm-up steps: {launches}; stats "
          f"{[int(x) for x in tr.last_stats]}")
    record_launches(report, launches, TRAINING_KERNELS, "Trainer")
    # The kernels' outputs of the first step vs their plain versions.
    label = f"Trainer {sz.trainer_views}x{r}x{r}"
    check_kernels(calls, label, report)
    check_backward(calls, label, report)
    del calls
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    t0 = time.perf_counter()
    start.record()
    step_losses = []
    for _ in range(sz.trainer_steps):
        state, loss = tr.step(state, *batch)
        step_losses.append(loss)
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / sz.trainer_steps
    ms = start.elapsed_time(end) / sz.trainer_steps
    losses += [float(x) for x in step_losses]
    print("  loss per step: " + ", ".join(f"{x:.6g}" for x in losses))
    print(f"  {ms:.3f} ms per step ({1e3 / ms:.2f} steps/s; host clock "
          f"{wall_ms:.3f} ms) over {sz.trainer_steps} steps after 2 warm-up steps, "
          f"on {card}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the Trainer's loss did not fall: {losses}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        save_checkpoint(path, state)
        tr2 = Trainer(mesh, opt, faces, r, r, 1.0, config, checkpoint_path=path)
        back = tr2.init_state(params)
    sd1, sd2 = state.opt_state.state_dict(), back.opt_state.state_dict()
    exact = (int(back.step) == int(state.step)
             and all(torch.equal(a, b) for a, b in zip(back.params, state.params))
             and sd1["param_groups"] == sd2["param_groups"]
             and all(torch.equal(v, sd2["state"][k][n])
                     for k in sd1["state"] for n, v in sd1["state"][k].items()))
    print(f"  checkpoint round trip (step {int(back.step)}, parameters and Adam "
          f"state): exact {exact}")
    if not exact:
        raise AssertionError("checkpoint round trip is not exact")
    return dict(trainer_ms_per_step=ms, trainer_steps_per_s=1e3 / ms,
                trainer_wall_ms_per_step=wall_ms, trainer_losses=losses)


def phase_suggest_config(dev, sz: Sizes):
    """suggest_config on the 1M-triangle 1080p headline scene; a render with
    the suggested config must truncate nothing."""
    import dataclasses

    from dmesh2_renderer_tpu_torch import render, suggest_config

    s, mv, proj, _ = headline_scene(dev, sz)
    print(f"phase 6d: suggest_config on the headline scene ({sz.n_faces} faces, "
          f"{sz.width}x{sz.height})")
    t0 = time.perf_counter()
    cfg = suggest_config(s["verts"], s["faces"], mv, proj, sz.width, sz.height)
    probe_s = time.perf_counter() - t0
    with torch.no_grad():
        color, _, aux = render(*scene_args(s)[:5], mv, proj, s["background"],
                               sz.width, sz.height, 1.0, cfg)
    sync()
    fields = {k: v for k, v in dataclasses.asdict(cfg).items()
              if k in ("binning_capacity", "max_tiles_per_face", "num_giant_faces",
                       "giant_tiles", "vertex_sort_mode")}
    print(f"  suggested {fields} (probe {probe_s:.3f} s on the host clock); render: "
          f"num_rendered={int(aux.num_rendered)} num_truncated={int(aux.num_truncated)}")
    if int(aux.num_truncated) != 0 or not torch.isfinite(color).all():
        raise AssertionError("the suggested config truncates the headline scene")
    return dict(suggested_config=fields, suggested_num_rendered=int(aux.num_rendered))


def phase_profile_render(dev, sz: Sizes, card):
    """profile_render on the headline scene with its config."""
    from dmesh2_renderer_tpu_torch.utils.profiling import profile_render

    s, mv, proj, config = headline_scene(dev, sz)
    print(f"phase 6e: profile_render on the headline scene ({sz.width}x{sz.height}, "
          f"{sz.profile_iters} calls per stage after one warm-up, CUDA events)")
    rep = profile_render(*scene_args(s)[:5], mv, proj, s["background"], sz.width,
                         sz.height, 1.0, config, iters=sz.profile_iters)
    print("  stages_ms: " + ", ".join(f"{k} {v:.3f}" for k, v in rep["stages_ms"].items()))
    print(f"  e2e_fwd_ms {rep['e2e_fwd_ms']:.3f}, e2e_ms {rep['e2e_ms']:.3f}, "
          f"unattributed_ms {rep['unattributed_ms']:.3f}; num_rendered "
          f"{rep['num_rendered']} num_truncated {rep['num_truncated']} num_binned "
          f"{rep['num_binned']} num_contributing {rep['num_contributing']}; on {card}")
    if rep["num_truncated"] != 0 or len(rep["stages_ms"]) != 6:
        raise AssertionError(f"profile_render: {rep}")
    return dict(profile_render=rep)


def grad_errors(got, want, label):
    """tests/test_face_parallel.py's bound, leaf by leaf: |got - want| <
    5e-5 x max(|want|, 1e-3) + 1e-7. Prints the largest error per leaf;
    raises when one exceeds its bound."""
    msgs = []
    for name, g, r in zip(("verts", "verts_color", "faces_opacity"), got, want):
        scale = max(float(r.abs().max()), 1e-3)
        err = float((g - r).abs().max())
        msgs.append(f"{name} {err:.3g}/{scale:.3g}")
        if not (torch.isfinite(g).all() and err < 5e-5 * scale + 1e-7):
            raise AssertionError(f"{label}: {name} gradient error {err} vs scale {scale}")
    print(f"  {label}: max|err|/scale " + ", ".join(msgs))


def depth_ranked(s, mv, proj, w, h):
    """The one-view scene ``s`` with its faces renumbered in their slab
    order (the stable ranks of the unquantized depth): a face's id then
    follows its depth, so one render breaks ties of the quantized depth as
    the slabs and the bands do, and they must agree with it."""
    from dmesh2_renderer_tpu_torch.parallel import face_parallel as FP

    order = FP.depth_slab_order(s["verts"], s["faces"], mv, proj, w, h)[0].long()
    return dict(s, faces=s["faces"][order].contiguous(),
                faces_opacity=s["faces_opacity"][order].contiguous(),
                faces_intense=s["faces_intense"][:, order].contiguous())


def tie_departure(err, allowed, share, label, sz: Sizes):
    """The pixels where a sharded frame departs from one render by more
    than ``allowed``: printed, and held to ``share`` of the frame and
    sz.tie_departure_max. Returns (count, largest error)."""
    over = err > allowed
    count, worst, n_pixels = int(over.sum()), float(err.max()), err.numel()
    print(f"  {label}: {count} of {n_pixels} pixels ({100.0 * count / n_pixels:.4f}%) "
          f"depart by more than that, the largest by {worst:.3g} (allowed: "
          f"{100.0 * share:g}% of the pixels, by at most {sz.tie_departure_max:g})")
    if count > share * n_pixels or worst > sz.tie_departure_max:
        raise AssertionError(f"{label}: {count} pixels depart, up to {worst}")
    return count, worst


def phase_face_slabs(dev, sz: Sizes, report, kernels, card):
    """Face slabs at full width: the renderer headline as sz.slabs depth
    slabs, the per-rank body for every slab in one process, folded with the
    over operator. The kernels of one slab forward and backward against
    their plain versions; the fold against functional.render on the scene
    renumbered in depth order with no giant tier and no exact tile cull
    (exact up to the early stop), and on the headline as it is (the
    departure at depth ties bounded); render_faces_sharded on a world of
    one; the gradients of the slabs summed against autograd of the
    unsharded loss on config 5's scene; the times."""
    from dmesh2_renderer_tpu_torch import render, render_partial
    from dmesh2_renderer_tpu_torch.parallel import (
        SceneParams, make_face_mesh, render_faces_sharded)
    from dmesh2_renderer_tpu_torch.parallel import face_parallel as FP
    from dmesh2_renderer_tpu_torch.utils.config import T_EPS

    n = sz.slabs
    s, mv, proj, config = headline_scene(dev, sz)
    mv, proj = (torch.as_tensor(x, device=dev) for x in (mv, proj))
    w, h = sz.width, sz.height
    print(f"phase 6f: face slabs, the renderer headline ({sz.n_faces} faces, {w}x{h}) "
          f"as {n} depth slabs, the per-rank body for each in one process")
    bg = s["background"]

    def slabs(sc, cfg, p=None):
        p = p or SceneParams(sc["verts"], sc["verts_color"], sc["faces_opacity"])
        order = FP.depth_slab_order(p.verts, sc["faces"], mv, proj, w, h)
        return [FP.render_slab(p, sc["faces"], sc["faces_intense"], mv, proj, order, w,
                               h, 1.0, cfg, k, n) for k in range(n)]

    def fold(parts):
        c, d, t = FP.composite_slabs(*(torch.stack([q[i] for q in parts])
                                       for i in range(3)))
        return c + t[..., None] * bg, 1.0 - ((d + t) + 1.0) / 2.0

    def against_render(sc, cfg):
        """The fold vs one render of ``sc``: (colour and depth error per
        pixel, the strict bound 2e-5 + T where one render stops early, the
        mask of those pixels, the slabs' entries and truncations, one
        render's aux)."""
        reset_launches(kernels)
        with torch.no_grad():
            parts = slabs(sc, cfg)
        launches = read_launches(kernels)
        record_launches(report, launches, FORWARD_KERNELS, "face-slab forward")
        color, depth = fold(parts)
        ref_c, ref_draw, ref_t, aux = render_partial(*scene_args(sc)[:5], mv, proj, bg,
                                                     w, h, 1.0, cfg)
        err = torch.maximum((color - ref_c).abs().amax(dim=-1),
                            (depth - 1.0 + (ref_draw + 1.0) / 2.0).abs())
        # Where one render stops early (final T < T_EPS) each slab still
        # composites on its own, so the fold adds the later slabs' colour and
        # depth times that T (both at most 1 here): the bound grows by it.
        stopped = ref_t < T_EPS
        bound = 2e-5 + torch.where(stopped, ref_t, torch.zeros_like(ref_t))
        nt = sum(int(q[4]) for q in parts)
        print(f"  launches on the {n}-slab forward: {launches}; slab entries "
              f"{[int(q[3]) for q in parts]} (one render {int(aux.num_rendered)}), "
              f"num_truncated {nt}")
        if nt or int(aux.num_truncated) or not torch.isfinite(color).all():
            raise AssertionError("face slabs: truncated or not finite")
        return err, bound, stopped

    # Exact: the faces renumbered in depth order, no giant tier, no exact
    # tile cull (a slab ranks faces by their depth, then id; one render by
    # the quantized depth, then tier, then id).
    ranked = depth_ranked(s, mv, proj, w, h)
    tie_free = dataclasses.replace(config, max_tiles_per_face=sz.tie_free_kt,
                                   num_giant_faces=0, exact_tile_cull=False,
                                   binning_capacity=sz.tie_free_capacity)
    err, bound, stopped = against_render(ranked, tie_free)

    def worst(where):
        return float(err[where].max()) if bool(where.any()) else 0.0

    ratio = float(err.div(bound).max())
    print(f"  {n} slabs folded vs functional.render, faces in depth order, no giant "
          f"tier, no exact tile cull: max|err| {worst(~stopped):.3g} on the "
          f"{int((~stopped).sum())} pixels where one render does not stop early; "
          f"{worst(stopped):.3g} on the {int(stopped.sum())} where it does (final T < "
          f"{T_EPS}), within 2e-5 + T; largest error / bound {ratio:.3g}")
    if not ratio <= 1.0:
        raise AssertionError(f"face slabs differ from render: error / bound {ratio}")
    strict_err = float(err.max())
    # The headline as it is: the fold departs from one render where faces'
    # quantized depths tie, as the JAX package's slabs do.
    err, bound, _ = against_render(s, config)
    departed = tie_departure(err, bound, sz.slab_tie_share,
                             f"headline config, {n} slabs vs functional.render "
                             "(strict bound 2e-5 + T)", sz)
    one_c, one_d, _ = render_faces_sharded(make_face_mesh(), *scene_args(ranked)[:5],
                                           mv, proj, bg, w, h, 1.0, config)
    ref_c, ref_d, _ = render(*scene_args(ranked)[:5], mv, proj, bg, w, h, 1.0, config)
    err1 = max(float((one_c - ref_c).abs().max()), float((one_d - ref_d).abs().max()))
    print(f"  render_faces_sharded, world of one, headline config, faces in depth "
          f"order, vs functional.render: max|err| {err1:.3g}")
    if not err1 <= 2e-5:
        raise AssertionError(f"render_faces_sharded on a world of one: {err1}")
    del one_c, one_d, ref_d, err, bound

    # The training step: the per-rank bodies, each slab backpropagated with
    # the combine's cotangents into the same leaves (their .grad sums the
    # slabs, as the all-reduce would), against one render's step.
    target = torch.zeros_like(ref_c)
    leaves = SceneParams(*(s[k].detach().clone().requires_grad_(True)
                           for k in ("verts", "verts_color", "faces_opacity")))
    faces, fi = s["faces"], s["faces_intense"]

    def slab_step():
        for x in leaves:
            x.grad = None
        parts = slabs(s, config, leaves)
        stacked = [torch.stack([q[i].detach() for q in parts]) for i in range(3)]
        _, g_c, g_t = FP.slab_cotangents(*stacked, target, bg)
        for k, q in enumerate(parts):
            torch.autograd.backward([q[0], q[2]], [g_c[k], g_t[k]])

    def one_step():
        for x in leaves:
            x.grad = None
        c, _, _ = render(leaves.verts, faces, leaves.verts_color, leaves.faces_opacity,
                         fi, mv, proj, bg, w, h, 1.0, config)
        torch.mean((c - target) ** 2).backward()

    reset_launches(kernels)
    with captured_kernel_calls(copy=True) as calls:
        slab_step()
    launches = read_launches(kernels)
    record_launches(report, launches, TRAINING_KERNELS, "face-slab training step")
    print(f"  launches on one {n}-slab training step: {launches}")
    # The kernels at a slab's own inputs: the last slab's forward and
    # backward of that step.
    label = f"slab {n - 1} of {n}, {w}x{h}"
    check_kernels(calls, label, report)
    check_backward(calls, label, report)
    del calls
    fwd_ms, fwd_runs = time_ms(lambda: fold(slabs(s, config)), sz.reps)
    one_ms, _ = time_ms(lambda: render(*scene_args(s)[:5], mv, proj, bg, w, h, 1.0,
                                       config), sz.reps)
    step_ms, _ = time_ms(slab_step, sz.reps)
    one_step_ms, _ = time_ms(one_step, sz.reps)
    print(f"  {n}-slab forward {fwd_ms:.3f} ms (runs {[round(t, 3) for t in fwd_runs]}) "
          f"vs one render {one_ms:.3f} ms; {n}-slab training step {step_ms:.3f} ms vs "
          f"one {one_step_ms:.3f} ms; on {card}")

    # Gradients on config 5's scene (sz.slab_grad_views views).
    params5, faces5, batch = config5_scene(sz)
    b, r = sz.slab_grad_views, sz.trainer_res
    faces5 = torch.as_tensor(faces5, device=dev)
    fi5, mv5, proj5, tgt5, bg5 = (torch.as_tensor(x[:b] if x.ndim > 1 else x,
                                                  device=dev) for x in batch)
    tgt5 = torch.as_tensor(np.random.default_rng(11).uniform(
        size=(b, r, r, 3)).astype(np.float32), device=dev)
    config5 = dataclasses.replace(config, binning_capacity=sz.trainer_capacity)

    def leaves5():
        return SceneParams(*(torch.as_tensor(x, device=dev).clone().requires_grad_(True)
                             for x in params5))

    want = leaves5()
    c, _, _ = render(want.verts, faces5, want.verts_color, want.faces_opacity, fi5,
                     mv5, proj5, bg5, r, r, 1.0, config5)
    torch.mean((c - tgt5) ** 2).backward()
    got = leaves5()
    order = FP.depth_slab_order(got.verts, faces5, mv5, proj5, r, r)
    parts = [FP.render_slab(got, faces5, fi5, mv5, proj5, order, r, r, 1.0, config5,
                            k, n) for k in range(n)]
    stacked = [torch.stack([q[i].detach() for q in parts]) for i in range(3)]
    _, g_c, g_t = FP.slab_cotangents(*stacked, tgt5, bg5)
    for k, q in enumerate(parts):
        torch.autograd.backward([q[0], q[2]], [g_c[k], g_t[k]])
    grad_errors([x.grad for x in got], [x.grad for x in want],
                f"config 5 scene ({b} views at {r}x{r}), {n} slabs' summed gradients "
                "vs autograd of the unsharded loss")
    return torch.no_grad()(lambda: fold(slabs(s, config))), dict(
        face_slabs=n, face_slab_forward_ms=fwd_ms, face_slab_forward_runs_ms=fwd_runs,
        face_one_forward_ms=one_ms, face_slab_step_ms=step_ms,
        face_one_step_ms=one_step_ms, face_slab_depth_ranked_err=strict_err,
        face_slab_tie_departure=departed)


def phase_pixel_bands(dev, sz: Sizes, report, kernels, card):
    """Pixel bands at full width: the renderer headline as sz.bands bands,
    the per-rank body for every band in one process, stitched. The kernels
    of one band off the tile grid against their plain versions; the stitch
    against functional.render on the scene renumbered in depth order with no
    giant tier and no exact tile cull (within 1e-6), and on the headline as
    it is (the departure at depth ties bounded); render_pixels_sharded on a
    world of one; the times."""
    from dmesh2_renderer_tpu_torch import render
    from dmesh2_renderer_tpu_torch.parallel import make_pixel_mesh, render_pixels_sharded
    from dmesh2_renderer_tpu_torch.parallel import patch_parallel as PP

    n = sz.bands
    s, mv, proj, config = headline_scene(dev, sz)
    mv, proj = (torch.as_tensor(x, device=dev) for x in (mv, proj))
    w, h = sz.width, sz.height
    band = h // n
    print(f"phase 6g: pixel bands, the renderer headline ({w}x{h}) as {n} bands of "
          f"{band} rows, the per-rank body for each in one process")

    def args(sc, cfg):
        return (*scene_args(sc)[:5], mv, proj, sc["background"], w, h, 1.0, cfg)

    def bands(sc, cfg):
        out = [PP.render_band(*args(sc, cfg), k, n) for k in range(n)]
        color = torch.cat([o[0] for o in out], dim=1)
        depth = 1.0 - (torch.cat([o[1] for o in out], dim=1) + 1.0) / 2.0
        return color, depth, sum(int(o[3].num_truncated) for o in out)

    # The kernels at band 1's own inputs: its origin y0 is off the tile grid.
    with torch.no_grad(), captured_kernel_calls() as calls:
        PP.render_band(*args(s, config), 1, n)
    check_kernels(calls, f"band 1 of {n} (rows {band}-{2 * band - 1}), {w}x{h}", report)
    del calls

    # A band tiles a face's rows from its own origin and quantizes depth for
    # its own tile grid, so ties of the quantized depth, a face's tile moving
    # between the binning's tiers and a face the exact cull keeps in one
    # tiling only can each change a pixel's order. With the faces in depth
    # order, no giant tier and no exact cull, no order changes.
    ranked = depth_ranked(s, mv, proj, w, h)
    tie_free = dataclasses.replace(config, max_tiles_per_face=sz.tie_free_kt,
                                   num_giant_faces=0, exact_tile_cull=False,
                                   binning_capacity=sz.tie_free_capacity)
    errs = {}
    for label, sc, cfg in (("faces in depth order, no giant tier, no exact tile cull",
                            ranked, tie_free), ("headline config", s, config)):
        reset_launches(kernels)
        with torch.no_grad():
            color, depth, nt = bands(sc, cfg)
        launches = read_launches(kernels)
        record_launches(report, launches, FORWARD_KERNELS, "pixel-band forward")
        with torch.no_grad():
            ref_c, ref_d, aux = render(*args(sc, cfg))
        err = torch.maximum((color - ref_c).abs().amax(dim=-1), (depth - ref_d).abs())
        same = torch.equal(color, ref_c) and torch.equal(depth, ref_d)
        errs[label] = float(err.max())
        print(f"  {label}: launches {launches}; num_truncated {nt} (one render "
              f"{int(aux.num_truncated)}); {n} bands stitched vs functional.render: "
              f"max|err| {errs[label]:.3g}, {int((err > 1e-6).sum())} pixels above "
              f"1e-6; bit-identical {same}")
        if nt or int(aux.num_truncated) or not torch.isfinite(color).all():
            raise AssertionError(f"pixel bands, {label}: truncated or not finite")
        if sc is ranked and not errs[label] <= 1e-6:
            raise AssertionError(f"pixel bands differ from render: {errs}")
    departed = tie_departure(err, 1e-6, sz.band_tie_share,
                             f"headline config, {n} bands vs functional.render", sz)
    one = render_pixels_sharded(make_pixel_mesh(), *args(s, config))
    ref_c, ref_d, _ = render(*args(s, config))
    same1 = torch.equal(one[0], ref_c) and torch.equal(one[1], ref_d)
    print(f"  render_pixels_sharded, world of one, equal to functional.render: {same1}")
    if not same1:
        raise AssertionError("render_pixels_sharded on a world of one differs from render")
    del one, ref_c, ref_d
    with torch.no_grad():
        band_ms, band_runs = time_ms(lambda: bands(s, config), sz.reps)
        one_ms, _ = time_ms(lambda: render(*args(s, config)), sz.reps)
    print(f"  {n}-band forward {band_ms:.3f} ms (runs {[round(t, 3) for t in band_runs]}) "
          f"vs one render {one_ms:.3f} ms (headline config); on {card}")
    return torch.no_grad()(lambda: bands(s, config)), dict(
        pixel_bands=n, band_forward_ms=band_ms, band_forward_runs_ms=band_runs,
        band_one_forward_ms=one_ms, band_errs=errs, band_tie_departure=departed)


def phase_grid_trainer(dev, sz: Sizes, report, kernels, card):
    """The Trainer on a ("dp", "sp") world of one at config 5 (the grid
    step): the loss falls, the three renderer kernels launch, ms per step.
    Then a (2, 2) grid in one process: the four (view half, band) bodies,
    their losses and gradients averaged as the all-reduce would, against
    make_sharded_train_step on a world of one."""
    import functools

    from dmesh2_renderer_tpu_torch import RasterConfig
    from dmesh2_renderer_tpu_torch.parallel import (
        SceneParams, make_mesh, make_sharded_train_step, make_view_mesh)
    from dmesh2_renderer_tpu_torch.parallel import patch_parallel as PP
    from dmesh2_renderer_tpu_torch.train import Trainer

    params, faces, batch = config5_scene(sz)
    r, b = sz.trainer_res, sz.trainer_views
    print(f"phase 6h: Trainer on a (1, 1) (\"dp\", \"sp\") mesh, config 5 "
          f"({b} views at {r}x{r}, Adam 1e-2)")
    config = RasterConfig(binning_capacity=sz.trainer_capacity)
    opt = functools.partial(torch.optim.Adam, lr=1e-2)
    tr = Trainer(make_mesh((1, 1), ("dp", "sp")), opt, faces, r, r, 1.0, config)
    state = tr.init_state(params)
    batch = tuple(torch.as_tensor(x, device=dev) for x in batch)
    reset_launches(kernels)
    losses = []
    with captured_kernel_calls(copy=True) as calls:  # warm-up; the first step
        state, loss = tr.step(state, *batch)
    losses.append(float(loss))
    state, loss = tr.step(state, *batch)
    losses.append(float(loss))
    launches = read_launches(kernels)
    record_launches(report, launches, TRAINING_KERNELS, "grid Trainer")
    print(f"  launches in the two warm-up steps: {launches}; step "
          f"{tr.step_fn.__qualname__.split('.')[0]}")
    # The kernels' outputs of the first step vs their plain versions.
    label = f"grid Trainer {b}x{r}x{r}"
    check_kernels(calls, label, report)
    check_backward(calls, label, report)
    del calls
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    step_losses = []
    for _ in range(sz.trainer_steps):
        state, loss = tr.step(state, *batch)
        step_losses.append(loss)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / sz.trainer_steps
    losses += [float(x) for x in step_losses]
    print("  loss per step: " + ", ".join(f"{x:.6g}" for x in losses))
    print(f"  {ms:.3f} ms per step ({1e3 / ms:.2f} steps/s) over {sz.trainer_steps} "
          f"steps after 2 warm-up steps, on {card}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the grid Trainer's loss did not fall: {losses}")

    # A (2, 2) grid in one process against the view step on a world of one.
    faces_t = torch.as_tensor(faces, device=dev)
    fi, mv, proj, _, bg = batch
    tgt = torch.as_tensor(np.random.default_rng(13).uniform(
        size=(b, r, r, 3)).astype(np.float32), device=dev)

    def leaves():
        return SceneParams(*(torch.as_tensor(x, device=dev).clone().requires_grad_(True)
                             for x in params))

    got = leaves()
    grads = [torch.zeros_like(x) for x in got]
    loss = 0.0
    band, half = r // 2, b // 2
    with captured_kernel_calls(copy=True) as calls:
        for i in range(2):
            v = slice(i * half, (i + 1) * half)
            for k in range(2):
                part, _ = PP.band_loss(got, faces_t, fi[v], mv[v], proj[v],
                                       tgt[v, k * band:(k + 1) * band], bg, r, r, 1.0,
                                       config, k, 2)
                for g, d in zip(grads, torch.autograd.grad(part, list(got))):
                    g += d
                loss += float(part.detach())
    loss /= 4
    # The kernels at the last body's own inputs: band 1 of the second half
    # of the views.
    label = f"(2, 2) grid body (1, 1): {half} views, rows {band}-{r - 1} of {r}x{r}"
    check_kernels(calls, label, report)
    check_backward(calls, label, report)
    del calls
    grads = [g / 4 for g in grads]
    step = make_sharded_train_step(make_view_mesh(), functools.partial(
        torch.optim.SGD, lr=0.0), faces, r, r, 1.0, config)
    want = leaves()
    _, _, want_loss, _ = step(want, step.init(want), fi, mv, proj, tgt, bg)
    rel = abs(loss - float(want_loss)) / abs(float(want_loss))
    msgs, ok = [], rel <= 1e-5
    for name, g, x in zip(("verts", "verts_color", "faces_opacity"), grads, want):
        scale = max(float(x.grad.abs().max()), 1.0)
        err = float((g - x.grad).abs().max())
        msgs.append(f"{name} {err:.3g}/{scale:.3g}")
        ok = ok and err <= 1e-6 * scale
    print(f"  (2, 2) grid bodies vs make_sharded_train_step (world of one): loss "
          f"{loss:.7g} vs {float(want_loss):.7g} (relative {rel:.3g}); gradients "
          f"max|err|/scale " + ", ".join(msgs))
    if not ok:
        raise AssertionError("the (2, 2) grid bodies differ from the view step")
    return dict(grid_trainer_ms_per_step=ms, grid_trainer_steps_per_s=1e3 / ms,
                grid_trainer_losses=losses, grid_2x2_loss_rel_err=rel)


def float32_ulp(x):
    """The float32 spacing at each |x| (x a float32 tensor)."""
    ax = x.abs()
    return torch.nextafter(ax, torch.full_like(ax, float("inf"))) - ax


def phase_calibration(dev, sz: Sizes, report, kernels, card):
    """1b: the float32 rate calibration (utils/fp32_rate.py). The
    uncontracted quad_map against its plain version bit for bit, the
    contracted one at L = 1 against a - x^2 in float64 rounded once and at
    every L against the interval [a - a^2, a]; then fp32_rate, whose
    launches are the path's, its rates against the data-sheet peak, and the
    kernel's time beside its bound and its plain version's."""
    from dmesh2_renderer_tpu_torch.utils import fp32_rate as FR

    print(f"phase 1b: float32 rate calibration, quad_map on a {FR.SHAPE} block")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-1.0, 1.6, size=FR.SHAPE).astype(np.float32),
                        device=dev)
    a = x * 1e-7 + 1.62
    a64 = a.double()
    for iters in sz.quad_map_iters:
        got, want = FR.quad_map(x, iters), FR.quad_map_plain(x, iters)
        sync()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        err = float((got - want).abs().max())
        print(f"  uncontracted L={iters}: identical bits to the plain version {same} "
              f"(max|err| {err:.3g})")
        if not same:
            raise AssertionError(f"quad_map differs from its plain version at L={iters}")
    one = FR.quad_map(x, 1, contract=True)
    exact = (a64 - x.double() ** 2).float()
    ulps = float(((one - exact).abs() / float32_ulp(exact)).max())
    print(f"  contracted L=1: within {ulps:g} ulp of a - x^2 in float64 rounded once")
    if ulps > 1.0:
        raise AssertionError(f"contracted quad_map at L=1 is {ulps} ulp off")
    slack = 4 * 2.0 ** -23                     # 4 ulp of [1, 2)
    for iters in sz.quad_map_iters + (FR.L_HI,):
        for contract in (False, True):
            y = FR.quad_map(x, iters, contract).double()
            inside = bool(((y <= a64 + slack) & (y >= a64 - a64 * a64 - slack)).all())
            if not inside:
                raise AssertionError(f"quad_map (contract={contract}) left "
                                     f"[a - a^2, a] at L={iters}")
    print(f"  both instances stay in [a - a^2, a] within 4 ulp at L = "
          f"{sz.quad_map_iters + (FR.L_HI,)}")

    reset_launches(kernels)
    rate = FR.fp32_rate(dev)
    launches = read_launches(kernels)
    record_launches(report, launches, CALIBRATION_KERNELS, "calibration")
    clock = rate["clock"]
    print(f"  fp32_rate on {rate['card']}, power limit {rate['power_limit']}; SM clock "
          f"{clock['sm_clock']} (max {clock['max_sm_clock']}, power draw "
          f"{clock['power_draw']}, read under load: {clock['under_load']})")
    for name in ("uncontracted", "contracted"):
        r = rate[name]
        print(f"  {name}: L={FR.L_LO} {r['ms_lo']:.4f} ms, L={FR.L_HI} {r['ms_hi']:.4f} ms "
              f"per launch -> {r['ops_per_s'] / 1e12:.3f}e12 float32 ops/s "
              f"({r['ops_per_s'] / FP32_OPS_PER_S:.1%} of {FP32_OPS_PER_S:.3g}), "
              f"launch overhead {r['overhead_us']:.2f} us")
        if not 0.0 < r["ops_per_s"] <= 1.05 * FP32_OPS_PER_S:
            raise AssertionError(f"{name} rate {r['ops_per_s']} is not a rate: above "
                                 "105% of the data-sheet peak, the count or the "
                                 "timing is wrong")
    print(f"  the uncontracted map over {FR.LOAD_LAUNCHES} launches of "
          f"{FR.LOAD_ITERS} iterations (the clock's load): "
          f"{clock['load_ops_per_s'] / 1e12:.3f}e12 ops/s")

    n = x.numel()
    plain_ms, _ = time_ms(lambda: FR.quad_map_plain(x, FR.L_LO), reps=3)
    ops = FR.OPS_PER_ITER * n * FR.L_LO + 2 * n            # the map, then a
    nbytes = 2 * 4 * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    bound, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    ms = rate["uncontracted"]["ms_lo"]
    report["quad_map"].update(
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, library_ms=None,
        iters=FR.L_LO, ms_contracted=rate["contracted"]["ms_lo"],
        ops_per_s_uncontracted=rate["uncontracted"]["ops_per_s"],
        ops_per_s_contracted=rate["contracted"]["ops_per_s"],
        sm_clock=clock["sm_clock"])
    print(f"  quad_map at L={FR.L_LO}: {ms:.4f} ms (contracted "
          f"{rate['contracted']['ms_lo']:.4f}), bound {bound:.4f} ms ({bound_by}: "
          f"{ops:.4g} ops, {nbytes} bytes), plain {plain_ms:.3f} ms, on {card}")
    return dict(fp32_rate=rate, quad_map_plain_ms=plain_ms)


def phase_fit_mesh(dev, sz: Sizes, report, kernels, card):
    """6i: the port's fitting example (examples/fit_mesh.py) at its defaults
    for sz.fit_steps steps with a temporary checkpoint: the three renderer
    kernels launch, the loss falls, nothing is truncated; resumed for
    sz.fit_resume_steps steps it starts where the first run stopped, its
    first two losses agree with two steps continued in-process from the
    same state (the second one after an Adam update, so it sees the
    restored moments) and its Adam step count goes on from the first run's.
    The kernels' outputs of the resumed run's last step are held against
    their plain versions at the example's inputs and tile budget."""
    import tempfile

    from dmesh2_renderer_tpu_torch.examples import fit_mesh
    from dmesh2_renderer_tpu_torch.utils.autotune import scene_binning_stats
    from dmesh2_renderer_tpu_torch.utils.meshes import icosphere

    print(f"phase 6i: examples/fit_mesh.py at its defaults, {sz.fit_steps} steps, "
          f"then resumed for {sz.fit_resume_steps}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "fit_mesh.npz")
        reset_launches(kernels)
        fit = fit_mesh.main(["--steps", str(sz.fit_steps), "--checkpoint", ckpt])
        launches = read_launches(kernels)
        record_launches(report, launches, TRAINING_KERNELS, "fitting example")
        losses = [float(v) for v in fit.losses]
        stats = [int(v) for v in fit.trainer.last_stats]
        print(f"  launches {launches}; stats (truncated, grad contributing) {stats}; "
              f"loss {losses[0]:.6g} -> {losses[-1]:.6g}; {fit.ms_per_step:.3f} ms "
              f"per step (host clock to the last loss readback) on {card}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"the example's loss did not fall: {losses}")
        if stats[0] != 0:
            raise AssertionError(f"the example truncated {stats[0]} face instances")
        _, mv, proj, target, _ = fit.batch
        h, w = target.shape[1:3]
        hist = scene_binning_stats(fit.state.params.verts.detach(), icosphere(3)[1], mv,
                                   proj, w, h, device=dev)["tiles_hist"]
        print(f"  per-face tile budget {fit.trainer.config.max_tiles_per_face}: at step "
              f"{sz.fit_steps} the largest face covers {int(hist.max())} tiles, "
              f"{int((hist > 4).sum())} of {hist.size} (view, face) pairs more than 4")
        state, cont = fit.state, []
        for _ in range(2):
            state, loss = fit.trainer.step(state, *fit.batch)
            cont.append(float(loss))
        with captured_kernel_calls(copy=True) as calls:
            second = fit_mesh.main(["--steps", str(sz.fit_resume_steps),
                                    "--checkpoint", ckpt])
    label = f"fitting example {len(target)}x{h}x{w}"
    check_kernels(calls, label, report)
    check_backward(calls, label, report)
    del calls
    start = int(second.state.step) - len(second.losses)
    first = [float(v) for v in second.losses[:2]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(first, cont))
    adam_steps = {int(v["step"]) for v in second.state.opt_state.state_dict()["state"].values()}
    print(f"  resumed at step {start}: first two losses "
          + ", ".join(f"{v:.9g}" for v in first) + "; continued in-process "
          + ", ".join(f"{v:.9g}" for v in cont) + f" (relative {rel:.3g}); Adam "
          f"step count {sorted(adam_steps)} after {len(second.losses)} steps; "
          f"{second.ms_per_step:.3f} ms per step with the kernels' arguments "
          "copied for the check")
    if start != sz.fit_steps:
        raise AssertionError(f"the resumed example started at step {start}")
    if not rel <= 1e-5:
        raise AssertionError(f"resumed losses {first} vs continued {cont}")
    if adam_steps != {int(second.state.step)}:
        raise AssertionError(f"the resumed Adam step count {adam_steps} does not go "
                             f"on from step {start}")
    return dict(fit_losses=losses, fit_ms_per_step=fit.ms_per_step,
                fit_resume_rel=rel)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 2
    from dmesh2_renderer_tpu_torch.ops import _kernels

    sz = Sizes()
    dev = torch.device("cuda")
    card = nvidia_smi_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _kernels.build_all()
    build_s = time.perf_counter() - t0
    print(f"phase 1: built {[k.name for k in _kernels.KERNELS]} in {build_s:.1f} s")
    for k in _kernels.KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {k.name}: {line.strip()}")
    resources = {k.name: k.occupancy() for k in _kernels.KERNELS}
    from dmesh2_renderer_tpu_torch.ops.peel import deep_occupancy, wide_occupancy
    resources["peel_wide"] = wide_occupancy(sz.sharded_layers)
    resources["peel_deep"] = deep_occupancy()
    for name, occ in resources.items():
        print(f"  {name}: {occ}")

    root = os.path.dirname(os.path.abspath(__file__))
    report = {k.name: dict(name=k.name, route="cuda",
                           source=os.path.relpath(k.source, root),
                           replaces=REPLACES[k.name], launches=0, max_abs_err=0.0)
              for k in _kernels.COUNTED}
    counted = _kernels.COUNTED
    phase_s = {}

    def run(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[label] = time.perf_counter() - t
        print(f"  [{label}: {phase_s[label]:.1f} s on the host clock]")
        return out

    calibration = run("1b", phase_calibration, dev, sz, report, counted, card)
    run("2", phase_kernel_checks, dev, sz, report)
    run("2b", phase_layered_checks, dev, sz, report)
    run("2d", phase_peel_adversarial, dev, sz, report)
    deep = run("2d-tiered", phase_peel_deep, dev, sz, report)
    run("2c", phase_stress, dev, sz, report)
    bin_emit = run("2e", phase_bin_emit, dev, sz, report)
    bin_emit.update(run("2f", phase_grad_reduce, dev, sz, report))
    renderer, s, forward, calls, work, bwd_work = run(
        "3", phase_main_path, dev, sz, report, counted)
    losses = run("3b", phase_training, dev, sz, renderer, s, forward)
    timings = run("4", phase_timing, dev, sz, report, renderer, s, forward, calls,
                  work, bwd_work)
    timings.update(adam_losses=losses, **bin_emit)
    # The layered path after the renderer's timings, which then run in the
    # state they ran in before the layered path existed.
    lr, scene_t, idx, peel_call, tiles, mask, peel_work = run(
        "5", phase_layered_main, dev, sz, report, counted)
    timings.update(run("6", phase_layered_timing, dev, sz, report, lr, scene_t, idx,
                       peel_call, tiles, peel_work))
    del peel_call
    timings.update(run("6b", phase_sharded_peel, dev, sz, report, counted, lr, scene_t,
                       tiles, mask, timings["peel_work"]))
    timings.update(run("6b-deep", phase_sharded_deep_peel, dev, sz, report, counted, lr,
                       scene_t, tiles, mask, timings["peel_work"], deep, card))
    del lr, scene_t, tiles, mask
    timings.update(run("6c", phase_trainer, dev, sz, report, counted, card))
    timings.update(run("6d", phase_suggest_config, dev, sz))
    timings.update(run("6e", phase_profile_render, dev, sz, card))
    # The sharded paths before phase 7 (the profiler slows later host work).
    slab_forward, t = run("6f", phase_face_slabs, dev, sz, report, counted, card)
    timings.update(t)
    band_forward, t = run("6g", phase_pixel_bands, dev, sz, report, counted, card)
    timings.update(t)
    timings.update(run("6h", phase_grid_trainer, dev, sz, report, counted, card))
    timings.update(run("6i", phase_fit_mesh, dev, sz, report, counted, card))
    timings.update(run("7", phase_device_busy, sz, s, forward, {
        f"{sz.slabs}_slab_forward": slab_forward, f"{sz.bands}_band_forward": band_forward}))
    timings.update(calibration, phase_s=phase_s)
    # The operation-bound kernels against the card's measured ceilings: the
    # uncontracted rate, as every port kernel is built, and the contracted.
    print("operation bounds at the measured float32 rates (bound_ms is at "
          f"{FP32_OPS_PER_S:.3g}):")
    rate = calibration["fp32_rate"]
    for entry in report.values():
        if entry.get("bound_by") == "operations":
            for name in ("uncontracted", "contracted"):
                entry[f"bound_ms_{name}"] = (entry["bound_ms"] * FP32_OPS_PER_S
                                             / rate[name]["ops_per_s"])
            print(f"  {entry['name']}: {entry['ms']:.4f} ms; bound {entry['bound_ms']:.4f}"
                  f" ms, at the uncontracted rate {entry['bound_ms_uncontracted']:.4f} ms"
                  f" ({entry['ms'] / entry['bound_ms_uncontracted']:.2f}x), at the "
                  f"contracted {entry['bound_ms_contracted']:.4f} ms")

    kernels_line = {"kernels": [report[k.name] for k in counted]}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(dict(card=card, torch=torch.__version__, build_s=build_s,
                       resources=resources, timings=timings, **kernels_line),
                  fh, indent=1)
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
