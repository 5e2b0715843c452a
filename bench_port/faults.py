"""Faults planted in the port's own timed path, which the output check has
to catch (``correct`` false). A loop kind lists its own in ``FAULTS`` as
(module, attribute, wrapper): the wrapper takes the original function and
returns the broken one.

* ``unchanged``: a step that returns its state unchanged: the backward
  compositor's records all zero (train); a frame whose tiles composite
  nothing (forward); a peel that returns its initial buffers.
* ``half_batch``: half of the batch left out: every other tile's list
  emptied after the binning; the peel's second view left out.
* ``altered``: an answer altered where it is produced: one pixel's colour
  by 0.01; the gradient record scaled by 1.5 whose opacity gradient is the
  largest of the rows the reduction reads, those of the contributing
  prefixes (train, trainer; the card leaves every other row unset); the
  first layer of every seventh pixel.

The cells run on one chip, so there is no exchange between chips to leave
out.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

from bench_port.reference.binning import REC_OP, contributing_mask

RASTERIZE = "dmesh2_renderer_tpu_torch.ops.rasterize"
FUNCTIONAL = "dmesh2_renderer_tpu_torch.functional"


def zero_records(orig):
    def f(*args):
        return torch.zeros_like(orig(*args))
    return f


def nothing_composited(orig):
    def f(records, starts, counts, *rest):
        return orig(records, starts, torch.zeros_like(counts), *rest)
    return f


def half_the_tiles(orig):
    def f(*args, **kw):
        b = orig(*args, **kw)
        counts = b.tile_counts.clone()
        counts[1::2] = 0
        return b._replace(tile_counts=counts)
    return f


def one_pixel(orig):
    def f(*args):
        color, *rest = orig(*args)
        color = color.clone()
        color[0, 5, 7, 1] += 0.01
        return (color, *rest)
    return f


def one_record(orig):
    """``composite_backward`` with one record scaled: the row of the
    largest |opacity gradient| among the contributing prefixes'. Rows
    outside them may hold anything (NaN, inf, stale bytes), and nothing
    reads them, so none of them is ever chosen."""
    def f(records, tile_starts, tile_counts, nc_tile, *rest):
        out = orig(records, tile_starts, tile_counts, nc_tile, *rest).clone()
        keep = contributing_mask(tile_starts, tile_counts, nc_tile, out.shape[0])
        opacity = torch.where(keep, out[:, REC_OP].abs(), -1.0)
        row = int(opacity.argmax())
        if not float(opacity[row]) > 0:
            raise RuntimeError("altered_gradient: no row of the contributing prefixes has "
                               "a non-zero opacity gradient, so the fault would alter nothing")
        out[row, :29] *= 1.5
        return out
    return f


def peel_initial(orig):
    def f(*args, **kw):
        layers, counts = orig(*args, **kw)
        return torch.full_like(layers, -1), torch.zeros_like(counts)
    return f


def peel_first_view(orig):
    def f(*args, **kw):
        layers, counts = orig(*args, **kw)
        layers, counts = layers.clone(), counts.clone()
        layers[1:], counts[1:] = -1, 0
        return layers, counts
    return f


def peel_every_seventh(orig):
    def f(*args, **kw):
        layers, counts = orig(*args, **kw)
        layers = layers.clone()
        first = layers.view(-1, layers.shape[-1])[::7, 0]
        first.copy_(torch.where(first >= 0, first + 1, 0))
        return layers, counts
    return f


# The renderer's faults, which the train and frames loops share.
RENDER = {
    "unchanged": (RASTERIZE, "composite_forward", nothing_composited),
    "half_batch": (RASTERIZE, "bin_faces", half_the_tiles),
    "altered": (RASTERIZE, "composite_forward", one_pixel),
}


@contextlib.contextmanager
def planted(loop: str, fault: str):
    """Within the block, ``fault`` of loop kind ``loop`` (its
    ``loops/<loop>.py``'s ``FAULTS``) is in the port."""
    from bench_port.harness import load_module

    module, name, wrap = load_module("loops", loop).FAULTS[fault]
    mod = importlib.import_module(module)
    orig = getattr(mod, name)
    setattr(mod, name, wrap(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)
