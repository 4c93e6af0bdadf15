"""Several processes, one device each: the device mesh
(:mod:`.mesh`), the parameter layouts of the sharding strategies
(:mod:`.sharding`) and ring attention over the sequence axis
(:mod:`.context`)."""
