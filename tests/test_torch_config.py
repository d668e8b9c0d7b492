"""The port's RenderConfig and enums mirror the JAX package's field for
field (names, declared types, defaults)."""

from __future__ import annotations

import dataclasses
import enum

import pytest
import torch

import gdpathtracing_tpu.config as jax_config
import gdpathtracing_torch.config as torch_config

torch.set_num_threads(1)


def _norm(v):
    """Compare enum members across the two packages by (class, value)."""
    if isinstance(v, enum.Enum):
        return type(v).__name__, v.value
    return v


def test_render_config_fields_match_jax():
    jf = dataclasses.fields(jax_config.RenderConfig)
    tf = dataclasses.fields(torch_config.RenderConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(tf, jf):
        assert a.type == b.type, a.name
        assert _norm(a.default) == _norm(b.default), a.name
    assert _norm(torch_config.RenderConfig().traversal) == ("Traversal",
                                                            "bvh")


@pytest.mark.parametrize("name", ["DenoisingMode", "Traversal", "Tonemap",
                                  "Jitter"])
def test_enums_match_jax(name):
    assert [(m.name, m.value) for m in getattr(torch_config, name)] == \
        [(m.name, m.value) for m in getattr(jax_config, name)]


def test_replace_and_hashable():
    c = torch_config.RenderConfig().replace(bounces=3)
    assert c.bounces == 3 and hash(c) == hash(c.replace())
