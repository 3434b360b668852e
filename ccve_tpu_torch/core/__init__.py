"""Host-side data model and workload generators."""
from ccve_tpu_torch.core.chunk import Chunk
from ccve_tpu_torch.core.collection import DataCollection

__all__ = ["Chunk", "DataCollection"]
