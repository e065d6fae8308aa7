"""The benchmark of the PyTorch and CUDA port (``klogs_tpu_torch``):
filterd under collectors' closed-loop flows. ``python3 -m portbench.run
--help``; ``PERF.md`` says what each cell and metric is for."""
