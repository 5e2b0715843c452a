"""``peel``: one iteration is one ``LayeredRenderer.generate`` at the mix's
``num_layers``. The check: the last call's layers and counts at every
pixel of ``mix["check_tiles"]`` tiles drawn from the seed."""

from __future__ import annotations

import torch

from bench_port import faults
from bench_port.loop import sample_tiles, tile_pixels
from bench_port.reference import render as ref
from bench_port.reference.binning import tile_grid_size

KERNELS = ("peel",)
FAULTS = {
    "unchanged": (faults.FUNCTIONAL, "peel_layers", faults.peel_initial),
    "half_batch": (faults.FUNCTIONAL, "peel_layers", faults.peel_first_view),
    "altered": (faults.FUNCTIONAL, "peel_layers", faults.peel_every_seventh),
}


class Loop:
    def __init__(self, scene, config, mix, device, spans):
        from dmesh2_renderer_tpu_torch import LayeredRenderer, RasterConfig

        self.scene, self.config, self.mix = scene, config, mix
        self.device, self.spans = device, spans
        self.width, self.height = int(config["width"]), int(config["height"])
        self.num_layers = int(mix["num_layers"])
        self.layered = LayeredRenderer(scene.mv, scene.proj, self.width, self.height,
                                       device=device, config=RasterConfig(**config["raster"]))
        self.views = list(range(scene.views))
        self.auxes = []
        self.last = None

    def step(self):
        s = self.scene
        with self.spans("generate"):
            self.last = self.layered.generate(self.views, s.verts, s.faces, s.tets, s.face_tets,
                                              s.tet_faces, s.exist, self.num_layers)
        self.auxes.append(self.layered.last_aux)

    def failed(self) -> int:
        return int(sum(int(a[1] > 0) for a in self.auxes))

    def outputs(self, seed):
        """The last call's layers and counts at the pixels of the tiles
        drawn from the seed (``mix["check_tiles"]`` of them)."""
        layers, counts = self.last
        gx, gy = tile_grid_size(self.width, self.height)
        tiles = sample_tiles(seed, self.scene.views * gx * gy, int(self.mix["check_tiles"]),
                             self.device)
        pix = tile_pixels(tiles, self.scene.views, self.width, self.height)
        b, y, x = pix[:, 0], pix[:, 1], pix[:, 2]
        return dict(tiles=tiles, pixels=pix, layers=layers[b, y, x].clone(),
                    counts=counts[b, y, x].clone(), num_rendered=int(self.auxes[-1][0]),
                    num_truncated=max(int(a[1]) for a in self.auxes))

    def release(self):
        self.layered = None
        self.auxes = []
        self.last = None

    @staticmethod
    def reference(scene, config, mix, precision, prog):
        return ref.peel(scene, int(config["width"]), int(config["height"]), config["raster"],
                        int(mix["num_layers"]), prog["tiles"], precision)

    @staticmethod
    def compare(prog, reference) -> dict:
        """``pixels_differ``: sampled pixels whose layers or count differ."""
        if not torch.equal(prog["pixels"], reference["pixels"]):
            raise ValueError("the program's and the reference's sampled pixels differ")
        differ = ((prog["layers"] != reference["layers"]).any(dim=1)
                  | (prog["counts"] != reference["counts"]))
        return dict(pixels_differ=int(differ.sum()),
                    rendered_gap=abs(prog["num_rendered"] - reference["num_rendered"]),
                    truncated=prog["num_truncated"])
