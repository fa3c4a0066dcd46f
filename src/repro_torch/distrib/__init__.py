"""The distributed layer: sharding plans as DTensor placements on a
``DeviceMesh`` (``sharding``), activation layout pins (``actsharding``)
and GPipe over a process group (``pipeline``)."""
