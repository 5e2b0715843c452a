"""Programs that drive the port end to end (``python -m
dmesh2_renderer_tpu_torch.examples.<name>``)."""
