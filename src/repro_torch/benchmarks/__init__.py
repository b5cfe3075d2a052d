"""The paper's experiments as twins of the reference's ``benchmarks/``
modules: the same tasks, grids, constants and CSV rows, on the port
(``python -m repro_torch.benchmarks.run``)."""
