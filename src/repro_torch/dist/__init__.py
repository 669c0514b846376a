"""Data-parallel collectives of the port (``torch.distributed``)."""
from .collectives import (dp_all_gather, dp_barrier, dp_rank, dp_world_size,
                          make_dp_pmean)

__all__ = ["dp_all_gather", "dp_barrier", "dp_rank", "dp_world_size",
           "make_dp_pmean"]
