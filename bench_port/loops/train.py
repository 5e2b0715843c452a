"""``train``: one iteration is ``Renderer.forward``, then ``loss.backward()``
of ``color.sum() + depth.sum()`` into cleared gradients of the vertices,
vertex colours, face opacities and intensities (the inputs are the same
every step). The check: the last step's image and its four gradients
against the reference's analytic backward."""

from __future__ import annotations

from bench_port import faults
from bench_port.loop import RendererLoop, render_numbers
from bench_port.reference import render as ref

TRAINABLE = ref.TRAINABLE
KERNELS = ("pack_stream", "composite_fwd", "composite_bwd")
FAULTS = dict(faults.RENDER,
              unchanged=(faults.RASTERIZE, "composite_backward", faults.zero_records),
              altered_gradient=(faults.RASTERIZE, "composite_backward", faults.one_record))


class Loop(RendererLoop):
    def __init__(self, scene, config, mix, device, spans):
        super().__init__(scene, config, mix, device, spans)
        self.params = {k: getattr(scene, k).detach().clone().requires_grad_(True)
                       for k in TRAINABLE}

    def step(self):
        p = self.params
        for t in p.values():
            t.grad = None
        with self.spans("forward"):
            color, depth = self.forward(p["verts"], p["verts_color"], p["faces_opacity"],
                                        p["faces_intense"])
        with self.spans("backward", sync=True):
            (color.sum() + depth.sum()).backward()
        self.last = (color.detach(), depth.detach())

    def outputs(self, seed):
        color, depth = self.last
        out = dict(color=color, depth=depth, **self.aux_outputs())
        out["grads"] = {k: t.grad for k, t in self.params.items()}
        return out

    def release(self):
        super().release()
        self.params = None

    @staticmethod
    def reference(scene, config, mix, precision, prog):
        return ref.render(scene, int(config["width"]), int(config["height"]),
                          float(config["aa_temperature"]), config["raster"], precision,
                          backward=True)

    @staticmethod
    def compare(prog, reference) -> dict:
        """The render's numbers and ``grad_gap``: over the four leaves, the
        largest norm of (program - reference) over the larger of the
        reference leaf's norm and the median leaf's norm."""
        nums = render_numbers(prog, reference)
        norms = {k: float(reference["grads"][k].norm()) for k in TRAINABLE}
        median = sorted(norms.values())[len(norms) // 2]
        worst = 0.0
        for k in TRAINABLE:
            g = prog["grads"][k]
            if g is None:
                return dict(nums, grad_gap=float("inf"))
            diff = float((g.float() - reference["grads"][k]).norm())
            worst = max(worst, diff / max(norms[k], median, 1e-30))
        return dict(nums, grad_gap=worst)
