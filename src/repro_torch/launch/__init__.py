"""Launch (``repro.launch``): the serve and train CLIs, the sharding rules
(``sharding``), the device meshes with the spec trees of the port's state
(``mesh``), a mesh's collectives and groups for tensor parallelism and the
model-sharded serve (``parallel``), and the analysis tools over every
(architecture x shape) cell: ``dryrun`` (rank 0's step on a fake world
under fake tensors: FLOPs, bytes, collectives and peak memory a device),
``roofline`` (the H100's roofline terms, JAX's ``param_count`` and
``model_flops``) and ``hlo_analyze`` (the largest ops of a cell's recorded
run)."""
