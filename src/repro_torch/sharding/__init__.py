"""Logical-axis sharding of the port on ``torch.distributed``.

``ctx`` (mesh context, resolution, ``shard``), ``rules`` (the rule sets and
the param/cache/batch/optimizer spec functions), ``collectives`` (the
collectives with their transposes as backward) and ``pipeline_parallel``
(GPipe over a ``stage`` axis). ``repro/sharding/compat.py``, a shim over jax
versions, has no twin here.
"""
