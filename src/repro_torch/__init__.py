"""PyTorch/CUDA port of the FedaGrac system (``repro`` is the JAX reference).

Subpackages mirror ``repro``'s names so each module's counterpart is easy to
find.  This package imports ``torch`` and numpy only — never ``jax`` and
nothing of ``repro`` — and keeps its own copy of what it needs.  Entry points
run on ``"cuda"`` unless the caller passes ``device="cpu"``
(``repro_torch.device.resolve_device``).
"""
