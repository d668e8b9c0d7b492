from gdpathtracing_torch.parallel.sharding import render_radiance_sharded
from gdpathtracing_torch.parallel.fault import (inject_tile_fault,
                                                redundancy_probe,
                                                render_with_retry,
                                                tile_health)

__all__ = ["render_radiance_sharded", "inject_tile_fault",
           "redundancy_probe", "render_with_retry", "tile_health"]
