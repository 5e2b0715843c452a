"""Multi-rank rendering and training over ``torch.distributed``: view
parallelism (``data_parallel.py``)."""

from dmesh2_renderer_tpu_torch.parallel.data_parallel import (
    RenderStats,
    SceneParams,
    ViewMesh,
    generate_layers_sharded,
    make_sharded_train_step,
    make_view_mesh,
    render_views_sharded,
)

__all__ = [
    "generate_layers_sharded",
    "RenderStats",
    "SceneParams",
    "ViewMesh",
    "make_sharded_train_step",
    "make_view_mesh",
    "render_views_sharded",
]
