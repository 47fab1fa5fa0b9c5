"""The general traffic generator: one closed-loop client of the port's entry points.

A traffic mix is a data file (``portbench/traffic/<mix>.json``) whose
``kind`` picks the entry point and whose other keys are its parameters:

* ``"ensemble"``: requests of ``batch`` radar crops (``context_frames``
  frames of ``output_shape``²), each asking
  ``inference.make_generate(model, num_samples=samples,
  shared_context=..., microbatch=...)`` for an ensemble, with a
  ``torch.Generator`` seeded from ``--seed`` and the request's index. A
  request is a host float32 array cast to the configuration's dtype and ends
  when its ``(S, B, T, 1, H, W)`` nowcast is on the host. ``pool`` distinct
  requests are drawn in set-up and cycled.
* ``"field"``: requests of one ``height`` x ``width`` composite (``pool``
  drawn in set-up, cycled) through ``inference.tiled_nowcast_device`` with
  ``tile``, ``overlap`` and ``batch_tiles``; each field's latent ``z`` is
  drawn from ``--seed`` and the field's index. A request ends when the
  stitched float32 field is on the host.

Both kinds also say what the reference checks (``check_answers``: requests,
or tiles of ``check_fields`` fields) and how many whole requests a traced
run records (``trace_answers``). Each kind knows the work its requests ask
for: the model forwards (their batches) and the least work of the model
(context stacks, latent stacks and sampler passes).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..reference.dgmr import Reference
from ..reference.tiling import cut_tile, interior, tile_corners
from . import inputs
from .seeds import derive, rng


def latent_shape(cfg) -> tuple:
    g = cfg["output_shape"] // 32
    return (8 * cfg["input_channels"], g, g)


def gaps(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """One answer's squared error and squared norm, and its widest gap and largest value."""
    got, want = got.double(), want.double()
    diff = got - want
    return {"err2": float((diff * diff).sum()), "norm2": float((want * want).sum()),
            "gap": float(diff.abs().max()), "peak": float(want.abs().max())}


def compared(rows: List[dict]) -> Dict[str, float]:
    """The numbers compared with the limits, over every answer checked.

    ``rel_l2``: the error's L2 norm over the reference's; ``max_gap``: the
    widest gap over the largest reference value. Both pool the answers, so a
    tile of little rain does not read as a large relative error.
    """
    norm2 = sum(r["norm2"] for r in rows)
    peak = max(r["peak"] for r in rows)
    return {"rel_l2": (sum(r["err2"] for r in rows) / max(norm2, 1e-300)) ** 0.5,
            "max_gap": max(r["gap"] for r in rows) / max(peak, 1e-300)}


class Ensemble:
    """Ensemble requests through ``make_generate``."""

    def __init__(self, cfg, mix, seed: int, device, dtype):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.dtype = torch.device(device), dtype
        self.batch, self.samples = mix["batch"], mix["samples"]
        n = mix["pool"] * self.batch
        pool = inputs.crops(derive(seed, "crops"), n, mix["context_frames"], cfg["output_shape"],
                            mix["blobs"], self.device)
        self.pool = pool.reshape(mix["pool"], self.batch, *pool.shape[1:])
        self.generate = None

    def attach(self, model) -> None:
        from skillful_nowcasting_tpu_torch.inference import make_generate

        self.generate = make_generate(model, num_samples=self.samples,
                                      shared_context=self.mix["shared_context"],
                                      microbatch=self.mix["microbatch"])

    def detach(self) -> None:
        self.generate = None

    def generator(self, k: int) -> torch.Generator:
        return torch.Generator().manual_seed(derive(self.seed, "request", k))

    def request(self, k: int):
        x = torch.from_numpy(self.pool[k % len(self.pool)]).to(self.dtype)
        return self.generate(x, self.generator(k)).cpu()

    def frames(self) -> int:
        """Nowcast frames one request brings to the host."""
        return self.samples * self.batch * self.cfg["forecast_steps"]

    def forwards(self) -> List[int]:
        """The batch of each model forward of a request: samples x chunks, or S x chunk shared."""
        cap = self.mix["microbatch"] or self.batch
        if self.mix["shared_context"]:
            cap = max(1, cap // self.samples)
            chunks = [min(cap, self.batch - s) for s in range(0, self.batch, cap)]
            return [self.samples * c for c in chunks]
        chunks = [min(cap, self.batch - s) for s in range(0, self.batch, cap)]
        return chunks * self.samples

    def least_work(self) -> Dict[str, int]:
        """What one request needs of the model: context stacks, latent stacks, sampler passes."""
        return {"context": self.batch, "latent": self.samples,
                "sampler": self.samples * self.batch}

    def keep(self, k: int) -> bool:
        return True

    def check(self, outputs: Dict[int, torch.Tensor], ref: Reference, ctrl=None) -> List[dict]:
        """The rows of a seeded sample of the finished requests (against ``ctrl`` if given)."""
        done = sorted(outputs)
        pick = rng(self.seed, "check").choice(len(done), min(self.mix["check_answers"], len(done)),
                                              replace=False)
        zs = latent_shape(self.cfg)
        rows = []
        for k in sorted(done[i] for i in pick):
            x = torch.from_numpy(self.pool[k % len(self.pool)]).to(self.device)
            z = torch.randn((self.samples, *zs), generator=self.generator(k))
            want = torch.stack([ref.forward(x, z[s:s + 1].to(self.device))
                                for s in range(self.samples)])
            if ctrl is None:
                got = outputs[k].to(self.device).float()
            else:
                got = torch.stack([ctrl.forward(x, z[s:s + 1].to(self.device))
                                   for s in range(self.samples)])
            rows.append({"answer": f"request {k}", **gaps(got, want)})
        return rows


class Field:
    """Composite fields through ``tiled_nowcast_device``."""

    def __init__(self, cfg, mix, seed: int, device, dtype):
        if mix["tile"] != cfg["output_shape"]:
            raise ValueError(f"tile {mix['tile']} differs from the model's output_shape "
                             f"{cfg['output_shape']}")
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.dtype = torch.device(device), dtype
        self.pool = [inputs.composite(derive(seed, "composite", p), mix["context_frames"],
                                      mix["height"], mix["width"], mix["cells"],
                                      tuple(mix["sigma_px"]), self.device)
                     for p in range(mix["pool"])]
        self.corners = tile_corners(mix["height"], mix["width"], mix["tile"], mix["overlap"])
        self.checked = set(rng(seed, "check_fields").choice(
            mix["pool"], mix["check_fields"], replace=False).tolist())
        self.model = None

    def attach(self, model) -> None:
        self.model = model

    def detach(self) -> None:
        self.model = None

    def z(self, k: int) -> torch.Tensor:
        gen = torch.Generator().manual_seed(derive(self.seed, "z", k))
        return torch.randn((1, *latent_shape(self.cfg)), generator=gen)

    def request(self, k: int) -> np.ndarray:
        from skillful_nowcasting_tpu_torch.inference import tiled_nowcast_device

        mix = self.mix
        return tiled_nowcast_device(self.model, self.pool[k % len(self.pool)], tile=mix["tile"],
                                    overlap=mix["overlap"], batch_tiles=mix["batch_tiles"],
                                    z=self.z(k), dtype=self.dtype)

    def frames(self) -> int:
        return self.cfg["forecast_steps"]

    def forwards(self) -> List[int]:
        n, b = len(self.corners), self.mix["batch_tiles"]
        return [min(b, n - s) for s in range(0, n, b)]

    def least_work(self) -> Dict[str, int]:
        n = len(self.corners)
        return {"context": n, "latent": 1, "sampler": n}

    def keep(self, k: int) -> bool:
        """Whether field ``k`` is kept for the check: of the window's first fields, as drawn."""
        return k in self.checked

    def check_tiles(self) -> List[int]:
        """The tiles compared: the four corners and a seeded draw of the rest."""
        n, cols = len(self.corners), len({j for _, j in self.corners})
        corners = {0, cols - 1, n - cols, n - 1}
        rest = [t for t in range(n) if t not in corners]
        want = min(len(rest), max(0, self.mix["check_tiles"] - len(corners)))
        extra = rng(self.seed, "check_tiles").choice(len(rest), want, replace=False)
        return sorted(corners | {rest[i] for i in extra})

    def check(self, outputs: Dict[int, np.ndarray], ref: Reference, ctrl=None) -> List[dict]:
        mix = self.mix
        tile, overlap, h, w = mix["tile"], mix["overlap"], mix["height"], mix["width"]
        tiles = self.check_tiles()
        rows = []
        for k in sorted(outputs):
            frames = self.pool[k % len(self.pool)]
            z = self.z(k).to(self.device)
            for s in range(0, len(tiles), mix["batch_tiles"]):
                block = tiles[s:s + mix["batch_tiles"]]
                batch = np.stack([cut_tile(frames, *self.corners[t], tile, overlap) for t in block])
                x = torch.from_numpy(batch).to(self.device)
                want = ref.forward(x, z)
                other = None if ctrl is None else ctrl.forward(x, z)
                for n, t in enumerate(block):
                    fy, fx, ty, tx = interior(*self.corners[t], h, w, tile, overlap)
                    if ctrl is None:
                        got = torch.from_numpy(np.ascontiguousarray(outputs[k][:, :, fy, fx]))
                    else:
                        got = other[n][:, :, ty, tx]
                    rows.append({"answer": f"field {k} tile {t}",
                                 **gaps(got.to(self.device), want[n][:, :, ty, tx])})
        return rows


KINDS = {"ensemble": Ensemble, "field": Field}
