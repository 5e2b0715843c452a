"""Benchmark of the PyTorch/CUDA port (``dmesh2_renderer_tpu_torch``).

``python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line. Configurations (``configs/``), traffic mixes (``mixes/``),
loop kinds (``loops/``), scene, camera and appearance generators
(``scenes/``, ``cameras/``, ``appearances/``), limits of the output checks
(``checks/``), metric readers (``metrics/``) and kernel work counts
(``counts/``) are files of their own, found by name.
"""
