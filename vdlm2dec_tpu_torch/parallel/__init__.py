"""Scale-out: the (chan, time) mesh on one host (sharding) and across
processes over torch.distributed (multihost)."""
