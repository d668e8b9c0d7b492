"""A run with its timed path broken underneath comes out not correct:
once for each fault the cells can have (a step that returns its state
unchanged; half of the batch left out; an answer altered where it is
produced; one card, so no exchange between cards to leave out). The
run's look for a card is skipped: the harness runs on the CPU at 16 x 12."""

import pytest
import torch

gpt = pytest.importorskip("gdpathtracing_torch")
import gdpathtracing_torch.diff.inverse as inverse  # noqa: E402
import gdpathtracing_torch.render.renderer as renderer  # noqa: E402
import gdpathtracing_torch.render.engine as engine  # noqa: E402


def _radiance_fault(monkeypatch, module, alter):
    real = module.render_radiance

    def faulty(*a, **k):
        aovs = real(*a, **k)
        return aovs._replace(radiance=alter(aovs.radiance))
    monkeypatch.setattr(module, "render_radiance", faulty)


def _half(x):
    return torch.cat([x[: x.shape[0] // 2], torch.zeros_like(
        x[x.shape[0] // 2:])])


def _one_pixel(x):
    x = x.clone()
    x[x.shape[0] // 2, x.shape[1] // 2] += 1.0
    return x


@pytest.mark.parametrize("cell", ["demo.interactive", "grid.interactive"])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_engine_faults(monkeypatch, run_small, grid_root, cell, fault):
    root = grid_root
    assert run_small(cell, root=root)["correct"]
    if fault == "unchanged":
        monkeypatch.setattr(
            engine, "render_frame",
            lambda scene, cam, cfg, state, fi: (
                torch.zeros_like(state.accum), state))
    else:
        _radiance_fault(monkeypatch, renderer,
                        _half if fault == "half" else _one_pixel)
    out = run_small(cell, root=root)
    assert out["correct"] is False
    assert out["checks"]["px_mismatch"]["value"] > \
        out["checks"]["px_mismatch"]["limit"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_inverse_faults(monkeypatch, run_small, fault):
    assert run_small("demo.inverse")["correct"]
    if fault == "unchanged":
        real = inverse.render_loss

        def no_step(params, *a, **k):
            return real(params.detach(), *a, **k).detach() + 0.0 * params.sum()
        monkeypatch.setattr(inverse, "render_loss", no_step)
    elif fault == "half":
        monkeypatch.setattr(
            inverse, "image_mse",
            lambda a, b: torch.mean((a[0::2] - b[0::2]) ** 2))
    else:
        _radiance_fault(monkeypatch, inverse, _one_pixel)
    out = run_small("demo.inverse")
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
