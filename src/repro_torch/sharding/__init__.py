"""Sharding of the multi-tenant serve over a ``torch.distributed`` group."""
