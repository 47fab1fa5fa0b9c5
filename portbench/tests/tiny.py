"""Small cells for the benchmark's CPU tests: the real cells' files, cut to a size a test holds."""

from __future__ import annotations

from portbench.harness.spec import load_cell

TINY_MODEL = dict(forecast_steps=3, output_shape=64, latent_channels=256, context_channels=32)
TINY_MIX = {
    "ensemble": dict(samples=2, pool=3, check_answers=2, trace_answers=2),
    "field": dict(height=150, width=230, cells=20, sigma_px=[3.0, 12.0], tile=64, overlap=16,
                  batch_tiles=4, check_tiles=6, trace_answers=3),
}


def tiny_cell(name: str, **config):
    """Cell ``name`` of ``BENCHMARK.json`` at the tiny size; ``config`` overrides its sizes."""
    cell = load_cell(name)
    cell.config.update(TINY_MODEL, **config)
    cell.traffic.update(TINY_MIX[cell.traffic["kind"]])
    return cell
