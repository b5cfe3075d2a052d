"""The launch layer (``repro.launch`` counterpart) on ``torch.distributed``
meshes: mesh construction and logical-axis rules (``mesh``), the sharding
specs of parameters, round state, batches and caches (``specs``), process
bootstrap (``distributed``) and the serving steps (``serve``)."""
