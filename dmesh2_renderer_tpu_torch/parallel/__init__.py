"""Multi-rank rendering and training over ``torch.distributed``: view
parallelism (``data_parallel.py``), face-list parallelism
(``face_parallel.py``) and pixel-band parallelism with the 2-D view x band
train step (``patch_parallel.py``), all on a :class:`RankMesh`."""

from dmesh2_renderer_tpu_torch.parallel.data_parallel import (
    RankMesh,
    RenderStats,
    SceneParams,
    ViewMesh,
    generate_layers_sharded,
    make_mesh,
    make_sharded_train_step,
    make_view_mesh,
    render_views_sharded,
)
from dmesh2_renderer_tpu_torch.parallel.face_parallel import (
    make_face_mesh,
    make_face_sharded_train_step,
    render_faces_sharded,
)
from dmesh2_renderer_tpu_torch.parallel.patch_parallel import (
    make_grid_train_step,
    make_pixel_mesh,
    render_pixels_sharded,
)

__all__ = [
    "generate_layers_sharded",
    "make_grid_train_step",
    "make_pixel_mesh",
    "render_pixels_sharded",
    "RenderStats",
    "SceneParams",
    "make_sharded_train_step",
    "make_view_mesh",
    "render_views_sharded",
    "make_face_mesh",
    "make_face_sharded_train_step",
    "render_faces_sharded",
    "RankMesh",
    "ViewMesh",
    "make_mesh",
]
