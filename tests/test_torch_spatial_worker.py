"""One rank of the port's spatially sharded checks on the CPU: ``python tests/test_torch_spatial_worker.py``.

``tests/test_torch_spatial.py`` starts four of these processes (``gloo``,
one thread each) on an inputs file it wrote, and reads what they write. It
imports torch and the port only, never JAX, and holds no tests. Each rank
writes ``rank<r>.pt`` into the output directory:

* ``window``: :func:`halo_window` of this rank's 4-row stripe of a field for
  several ``rows``, against the slice of the dense field it stands for;
* ``layers``: a float64 ConvGRU (sequence and static input, T=4: windows of
  9 rows over 4-row stripes) and GBlock on this rank's stripe under the
  world's space layout, against the dense layer's rows;
* one entry per mesh, ``(data=2, space=2)`` and ``(data=1, space=4)``:
  :func:`make_spatial_forward` of the tiny DGMR with a fixed latent, its
  stripe's shape, the halo calls and bytes of one forward, the stripes
  gathered over the mesh (rank 0 keeps the whole nowcast) against the
  port's dense forward of the same rows on this rank, and the same with a
  seeded generator in place of the latent.
"""

from __future__ import annotations

import argparse
import os
import sys
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from skillful_nowcasting_tpu_torch import DGMR, profiling  # noqa: E402
from skillful_nowcasting_tpu_torch.layers.convgru import ConvGRU  # noqa: E402
from skillful_nowcasting_tpu_torch.models.common import GBlock  # noqa: E402
from skillful_nowcasting_tpu_torch.parallel import (  # noqa: E402
    SpaceLayout,
    gather_rows,
    gather_space,
    halo_exchange,
    halo_window,
    make_mesh,
    make_spatial_forward,
    shard_batch,
)
from skillful_nowcasting_tpu_torch.utils import random_fill  # noqa: E402

WINDOW_ROWS = (1, 2, 5, 9)
MESHES = {"data2_space2": (2, 2), "data1_space4": (1, 4)}


def relative(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def window_mode(field: torch.Tensor, rank: int, world: int) -> dict:
    each = field.shape[-2] // world
    mine = field[..., rank * each:(rank + 1) * each, :]
    out = {}
    for rows in WINDOW_ROWS:
        xw, top, bottom = halo_window(mine, rows, dist.group.WORLD)
        lo, hi = max(0, rank * each - rows), min(field.shape[-2], (rank + 1) * each + rows)
        out[rows] = {"equal": bool(torch.equal(xw, field[..., lo:hi, :])),
                     "top": top, "bottom": bottom, "want": (rank * each - lo, hi - (rank + 1) * each)}
    return out


def layers_mode(rank: int, world: int, each: int = 4, steps: int = 4) -> dict:
    gen = torch.Generator().manual_seed(7)  # the same layers and inputs on every rank
    gru = random_fill(ConvGRU(6 + 5, 5), gen).double().eval()
    block = random_fill(GBlock(6, 6), gen).double().eval()

    def field(*shape):
        return torch.randn((*shape, each * world, 7), generator=gen, dtype=torch.float64)

    x_seq, h0, x_static, x = field(steps, 1, 6), field(1, 5), field(1, 6), field(2, 6)
    mine = slice(rank * each, (rank + 1) * each)
    space = SpaceLayout(dist.group.WORLD, rank)
    with torch.no_grad():
        return {
            "gru_seq": relative(gru(x_seq[..., mine, :], h0[..., mine, :], space=space),
                                gru(x_seq, h0)[..., mine, :]),
            "gru_static": relative(
                gru(x_static, h0[..., mine, :], n_steps=steps, x_static=True, space=space),
                gru(x_static, h0, n_steps=steps, x_static=True)[..., mine, :]),
            "gblock": relative(block(x[..., mine, :], space=space), block(x)[..., mine, :]),
        }


def forward_mode(model, inputs: dict, n_data: int, n_space: int) -> dict:
    mesh = make_mesh(n_data, n_space=n_space, device="cpu")
    fwd = make_spatial_forward(model, mesh)
    x, z = inputs["x"], inputs["z"]
    for fn in (halo_window, halo_exchange):
        fn.calls, fn.bytes = 0, 0
    with torch.no_grad():
        with profiling.record() as log:
            y = fwd(x, z=z)
        names = [s["name"] for s in log.spans()]
        counts = {"window_calls": halo_window.calls, "window_bytes": halo_window.bytes,
                  "exchange_calls": halo_exchange.calls, "exchange_bytes": halo_exchange.bytes,
                  "window_spans": names.count("dgmr.halo.window"),
                  "exchange_spans": names.count("dgmr.halo.exchange")}
        mine = shard_batch(x, mesh)
        dense = model(mine, z=z)
        seeded = gather_space(fwd(x, generator=torch.Generator().manual_seed(5)), mesh)
        dense_seeded = model(mine, generator=torch.Generator().manual_seed(5))
    stripes = gather_space(y, mesh)
    out = {"shape": tuple(y.shape), **counts,
           "vs_dense": relative(stripes, dense), "seeded_vs_dense": relative(seeded, dense_seeded)}
    whole = stripes if mesh.data_group is None else torch.cat(
        list(gather_rows(stripes, mesh.data_group)), dim=0)
    if mesh.rank == 0:
        out["whole"] = whole
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--inputs", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.port}", rank=args.rank,
                            world_size=args.world, timeout=timedelta(seconds=120))
    try:
        inputs = torch.load(args.inputs, weights_only=False)
        model = DGMR(**inputs["config"], device="cpu")
        model.load_state_dict(inputs["state_dict"], strict=True)
        model.eval()
        out = {"window": window_mode(inputs["field"], args.rank, args.world),
               "layers": layers_mode(args.rank, args.world)}
        for name, (n_data, n_space) in MESHES.items():
            out[name] = forward_mode(model, inputs, n_data, n_space)
        torch.save(out, os.path.join(args.out, f"rank{args.rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
