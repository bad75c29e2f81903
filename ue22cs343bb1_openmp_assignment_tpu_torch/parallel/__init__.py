"""Explicit cross-shard transports of the message-level engine: the
shard layout, lane bucketing, the all_to_all and rdma lane exchanges
(the latter a CUDA kernel, ``ring_kernel``) and the routed cycle."""
