"""Data-parallel collectives of the port (``torch.distributed``)."""
from .collectives import dp_rank, dp_world_size, make_dp_pmean

__all__ = ["dp_rank", "dp_world_size", "make_dp_pmean"]
