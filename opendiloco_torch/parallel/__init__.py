"""Intra-worker parallelism over ``torch.distributed``: the device mesh of
a sharding strategy (:mod:`.mesh`), which dim of each leaf it shards
(:mod:`.sharding`), the collectives on blocks of a leaf (:mod:`.comm`), the routed-expert
FFN's collectives over the ep and data groups (:mod:`.experts`) and the
world messenger that joins a sharded worker to the outer loop
(:mod:`.world`)."""
