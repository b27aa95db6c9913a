"""Walkthroughs of the port, one module each, run as
``python -m wdbx_tpu_torch.examples.<name> [--device cpu]``:
``basic_usage``, ``rag_implementation``, ``clustered_at_scale``,
``sharded_serving`` and ``production_serving`` (the last two on a mesh
of 8 logical shards by default). Each is the port's counterpart of the
file of the same name in ``examples/``."""
