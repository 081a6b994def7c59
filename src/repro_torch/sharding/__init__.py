"""Sharding, ported from ``repro.sharding``: the logical-axis rules that
place each leaf on a ``DeviceMesh`` (``rules``) and the activation
context the model code constrains through (``ctx``)."""
