from gdpathtracing_torch.bvh.blas import BLASBuilder, BLASArrays
from gdpathtracing_torch.bvh.tlas import build_tlas, TLASArrays

__all__ = ["BLASBuilder", "BLASArrays", "build_tlas", "TLASArrays"]
