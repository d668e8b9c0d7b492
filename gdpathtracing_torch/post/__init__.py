from gdpathtracing_torch.post.tonemap import aces_film

__all__ = ["aces_film"]
