"""Distribution over torch.distributed ranks: the sharding rules, the
tensor-parallel kernel regions, Ring-SFA and gradient compression."""
