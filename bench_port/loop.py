"""What the loop kinds of ``loops/`` share.

A mix file names its loop kind (``"loop"``), and the harness loads
``loops/<kind>.py``, which has

* ``Loop``: built from (scene, config, mix, device, spans); ``step()`` runs
  one iteration and returns its latency in ms, or None; ``failed()``,
  ``outputs(seed)`` (what the last iteration produced) and ``release()``;
  and the static ``reference(scene, config, mix, precision, prog)``, which
  works the same answers out with the plain reference, and
  ``compare(prog, reference)``, which gives the numbers that the cell's
  limits judge;
* ``KERNELS``: the names of the port's hand-written kernels the loop
  launches, which set-up builds or loads before anything else;
* ``FAULTS``: the faults of ``faults.py`` that its output check has to
  catch, by name: (module, attribute, wrapper).

Every loop is closed: one caller, the next iteration after the previous
one returned.
"""

from __future__ import annotations

import torch

from bench_port.reference.binning import tile_grid_size, tile_lanes
from bench_port.scene import generator


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def gap(a, b) -> float:
    """The largest absolute difference of two tensors."""
    d = (a.float() - b.float()).abs()
    return float(d.max()) if d.numel() else 0.0


def render_numbers(prog, reference) -> dict:
    return dict(color_gap=gap(prog["color"], reference["color"]),
                depth_gap=gap(prog["depth"], reference["depth"]),
                rendered_gap=abs(prog["num_rendered"] - reference["num_rendered"]),
                truncated=prog["num_truncated"])


class RendererLoop:
    """The port's ``Renderer`` on the scene, for loops that render it."""

    def __init__(self, scene, config, mix, device, spans):
        from dmesh2_renderer_tpu_torch import RasterConfig, Renderer

        self.scene, self.config, self.mix = scene, config, mix
        self.device, self.spans = device, spans
        self.width, self.height = int(config["width"]), int(config["height"])
        self.tau = float(config["aa_temperature"])
        self.renderer = Renderer(scene.mv, scene.proj, self.width, self.height,
                                 device=device, config=RasterConfig(**config["raster"]))
        self.views = list(range(scene.views))
        self.origins = [[0, 0]] * scene.views
        self.auxes = []
        self.last = None

    def forward(self, verts, verts_color, faces_opacity, faces_intense):
        s = self.scene
        out = self.renderer.forward(self.views, self.origins, self.width, self.height, verts,
                                    s.faces, verts_color, faces_opacity, faces_intense,
                                    s.background, self.tau)
        self.auxes.append(self.renderer.last_aux)
        return out

    def failed(self) -> int:
        """Iterations whose binning truncated an entry."""
        if not self.auxes:
            return 0
        return int(sum(int(a.num_truncated > 0) for a in self.auxes))

    def aux_outputs(self):
        aux = self.auxes[-1]
        return dict(num_rendered=int(aux.num_rendered),
                    num_truncated=max(int(a.num_truncated) for a in self.auxes))

    def release(self):
        self.renderer = None
        self.auxes = []
        self.last = None


def sample_tiles(seed: int, n_tiles: int, k: int, device) -> torch.Tensor:
    """``k`` distinct tile ids drawn from the seed, sorted."""
    perm = torch.randperm(n_tiles, generator=generator(seed, "cpu"))
    return perm[:min(k, n_tiles)].sort().values.to(device)


def tile_pixels(tiles, views, width, height):
    """(N, 3) (batch, y, x) of the in-frame pixels of ``tiles``, tile by
    tile, lanes in row-major order: the reference peel's order."""
    gx, gy = tile_grid_size(width, height)
    bt, x, y, in_frame = tile_lanes(tiles, gx, gy, width, height)
    sel = in_frame.nonzero(as_tuple=True)
    return torch.stack([bt[:, None].expand_as(x)[sel], y[sel], x[sel]], dim=1)
