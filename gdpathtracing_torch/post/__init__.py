from gdpathtracing_torch.post.tonemap import aces_film
from gdpathtracing_torch.post.progressive import (ProgressiveState,
                                                  progressive_init,
                                                  progressive_update)
from gdpathtracing_torch.post.temporal import (TemporalState, temporal_init,
                                               temporal_update)

__all__ = [
    "aces_film", "ProgressiveState", "progressive_init", "progressive_update",
    "TemporalState", "temporal_init", "temporal_update",
]
