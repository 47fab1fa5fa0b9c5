"""One rank of the port's data-parallel checks on the CPU: ``python tests/test_torch_parallel_worker.py``.

``tests/test_torch_parallel.py`` starts two of these processes (``gloo``,
one thread each) on an inputs file it wrote, and reads what they write. It
imports torch and the port only, never JAX, and holds no tests. Each rank
runs every scenario in order and writes ``rank<r>.pt`` into the output
directory; rank 0 writes the tensors the test compares, rank 1 its own
checks. The scenarios:

* ``shard_map`` / ``pjit``: one float64 SGD train step in each DP mode on
  this rank's row of the batch, with explicit draws (per rank / shared);
* ``eval``: the DP eval step against the plain eval step of each rank, with
  explicit draws and with draws from :func:`~training.rank_generator`;
* ``generate``: :func:`make_dp_generate` against :func:`make_generate`;
* ``tilers``: both tilers on a mesh against one rank's run;
* ``halo``: :func:`halo_conv2d` of this rank's rows of a field;
* ``trainer``: a 2-step ``Trainer.fit`` on 2 ranks (checkpoints written by
  rank 0 only, replicas equal), resumed by every rank to step 3.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
# torch.utils.tensorboard imports TensorFlow where it is installed (seconds): log without it.
sys.modules["torch.utils.tensorboard"] = None

from skillful_nowcasting_tpu_torch import DGMR, checkpoint, training  # noqa: E402
from skillful_nowcasting_tpu_torch.data import synthetic_radar_batches  # noqa: E402
from skillful_nowcasting_tpu_torch.inference import (  # noqa: E402
    make_generate,
    tiled_nowcast,
    tiled_nowcast_device,
)
from skillful_nowcasting_tpu_torch.parallel import (  # noqa: E402
    gather_rows,
    halo_conv2d,
    make_dp_eval_step,
    make_dp_generate,
    make_dp_train_step,
    make_mesh,
)
from skillful_nowcasting_tpu_torch.trainer import Trainer  # noqa: E402
from skillful_nowcasting_tpu_torch.utils import random_fill  # noqa: E402

LR = (5e-5, 2e-4)  # SGD for G, D
# The Trainer scenario's model: the smallest field the paper's towers take.
SMALL = dict(forecast_steps=2, output_shape=32, latent_channels=256, context_channels=32,
             generation_steps=1, num_samples=2, num_spatial_layers=1, num_temporal_layers=1)


def model_from(inputs, dtype=torch.float32):
    model = DGMR(**inputs["config"], device="cpu")
    model.load_state_dict(inputs["state_dict"], strict=True)
    return model.to(dtype)


def sgd_state(model):
    g, d = training.split_params(model)
    return training.init_train_state(
        model, (torch.optim.SGD(g.values(), lr=LR[0]), torch.optim.SGD(d.values(), lr=LR[1])))


def flat(model) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).double() for t in model.state_dict().values()])


def replicas_equal(model) -> bool:
    """Every rank's parameters and buffers, bit for bit (gathered, compared on every rank)."""
    rows = gather_rows(flat(model), dist.group.WORLD)
    return bool((rows == rows[0]).all())


def draws(d) -> training.StepDraws:
    return training.StepDraws(**d)


def train_mode(inputs, mesh, mode, rank):
    model = model_from(inputs, torch.float64)
    state = sgd_state(model)
    step = make_dp_train_step(model, mesh, mode=mode, logging_forward=False, return_grads=True)
    x, y = inputs["x"].double(), inputs["y"].double()
    d = inputs["draws"][mode]
    metrics = step(state, x[rank:rank + 1], y[rank:rank + 1], draws=draws(d[rank] if mode ==
                                                                         "shard_map" else d))
    out = {"equal": replicas_equal(model)}
    if rank == 0:  # float32 copies: the comparison is at 1e-3 of each tensor
        out.update(
            metrics={k: v.item() for k, v in metrics.items() if k.startswith("train/")},
            g_grads={k: v.float() for k, v in metrics["g_grads"].items()},
            d_grads={k: v.float() for k, v in metrics["d_grads"].items()},
            state={k: v.float() for k, v in model.state_dict().items()
                   if not k.endswith("num_batches_tracked")},
        )
    return out


def eval_mode(inputs, mesh, rank):
    model = model_from(inputs)
    state = training.init_train_state(model)
    x, y = inputs["x"][rank:rank + 1], inputs["y"][rank:rank + 1]
    group = dist.group.WORLD
    mine = draws(inputs["draws"]["eval"][rank])
    dp_step, plain = make_dp_eval_step(model, mesh), training.make_eval_step(model)
    keys = sorted(plain(state, x, y, draws=mine))

    def gathered(metrics):
        return gather_rows(torch.stack([metrics[k].float() for k in keys]), group)

    explicit = dp_step(state, x, y, draws=mine)
    seeded = dp_step(state, x, y, torch.Generator().manual_seed(5))
    # pjit: the same draws on every rank give the global batch's metrics.
    shared = draws(inputs["draws"]["eval"][0])
    pjit = make_dp_eval_step(model, mesh, mode="pjit")(state, x, y, draws=shared)
    whole = plain(state, inputs["x"], inputs["y"], draws=shared)
    return {"keys": keys,
            "pjit": torch.stack([pjit[k].float() for k in keys]),
            "whole": torch.stack([whole[k].float() for k in keys]),
            "explicit": torch.stack([explicit[k].float() for k in keys]),
            "explicit_ranks": gathered(plain(state, x, y, draws=mine)),
            "seeded": torch.stack([seeded[k].float() for k in keys]),
            "seeded_ranks": gathered(plain(state, x, y, training.rank_generator(
                torch.Generator().manual_seed(5), group)))}


def generate_mode(inputs, mesh, rank):
    model = model_from(inputs).eval()
    x = inputs["x"]
    mine = make_dp_generate(model, mesh, num_samples=2)(x, torch.Generator().manual_seed(9))
    rows = gather_rows(mine, dist.group.WORLD)  # (ranks, S, 1, T, C, H, W)
    out = {"own_rows": bool(torch.equal(
        mine, make_generate(model, 2)(x[rank:rank + 1], torch.Generator().manual_seed(9))))}
    if rank == 0:
        whole = make_generate(model, 2)(x, torch.Generator().manual_seed(9))
        out["dp"], out["whole"] = torch.cat(list(rows), dim=1), whole
    return out


def tilers_mode(inputs, mesh, rank):
    model = model_from(inputs).eval()
    field, z = inputs["field"], inputs["z"]
    kw = dict(tile=64, overlap=16, z=z)
    dev = tiled_nowcast_device(model, field, batch_tiles=3, mesh=mesh, **kw)
    host = tiled_nowcast(model, field, batch_tiles=4, mesh=mesh, **kw)
    out = {"returned": [dev is not None, host is not None]}  # rank 0 only
    if rank == 0:  # against one rank's runs with the same forwards
        out["device"], out["host"] = torch.from_numpy(dev), torch.from_numpy(host)
        out["device_one"] = torch.from_numpy(
            tiled_nowcast_device(model, field, batch_tiles=3, **kw))
        out["host_one"] = torch.from_numpy(tiled_nowcast(model, field, batch_tiles=2, **kw))
    return out


def halo_mode(inputs, rank):
    out = {}
    for name, (x, w) in inputs["halo"].items():
        rows = x.shape[2] // 2
        mine = halo_conv2d(x[:, :, rank * rows:(rank + 1) * rows], w, dist.group.WORLD,
                           padding=(w.shape[2] - 1) // 2)
        out[name] = torch.cat(list(gather_rows(mine, dist.group.WORLD)), dim=2)
    return out


def trainer_mode(root: Path, mesh, rank):
    """2 steps, then a new Trainer on every rank resumes to step 3; checks per rank."""
    saves = []
    save = checkpoint.CheckpointManager.save

    def counted(self, step, payload, metrics=None):
        saves.append(step)
        return save(self, step, payload, metrics)

    checkpoint.CheckpointManager.save = counted

    def data(skip=0):  # this rank's stream
        it = synthetic_radar_batches(batch_size=1, target_frames=2, size=32, seed=30 + rank)
        return itertools.islice(it, skip, None)

    def fit(model, max_steps, skip=0):
        t = Trainer(model, max_steps=max_steps, ckpt_dir=str(root / "ckpt"),
                    log_dir=str(root / "log"), ckpt_every=1, log_every=1, val_every=2,
                    logging_forward=False, prefetch=0, seed=5, mesh=mesh)
        equal = []
        step = t.train_step

        def checked(*args, **kw):
            metrics = step(*args, **kw)
            equal.append(replicas_equal(t.model))
            return metrics

        t.train_step = checked
        val = synthetic_radar_batches(batch_size=1, target_frames=2, size=32, seed=40 + rank)
        return t, t.fit(data(skip), val), equal

    def small(seed):  # each rank starts from other weights; fit replicates rank 0's
        model = random_fill(DGMR(**SMALL, device="cpu"), torch.Generator().manual_seed(seed))
        return training.desaturate_discriminator(model)

    try:
        first, state, equal = fit(small(10 + rank), 2)
        payload = first.manager.restore(2)
        resumed_from = []
        restore = checkpoint.restore_state

        def recorded(*args, **kw):
            resumed_from.append(restore(*args, **kw))
            return resumed_from[-1]

        import skillful_nowcasting_tpu_torch.trainer as trainer_module

        trainer_module.restore_state = recorded
        _, state, more = fit(small(20 + rank), 3, skip=1)
        trainer_module.restore_state = restore
    finally:
        checkpoint.CheckpointManager.save = save
    return {
        "equal_after_each_step": equal + more,
        "saves": saves,
        "quiet_logger": type(first.logger).__name__,
        "rank_generators": len(payload.get("rank_generators", [])),
        "generator_restored": bool(torch.equal(
            payload["rank_generators"][rank], payload["generator"])),
        "resumed_from": resumed_from,
        "final_step": state.step,
        "files": sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()),
        "log_lines": len((root / "log" / "metrics.jsonl").read_text().splitlines()),
    }


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--inputs", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.port}", rank=args.rank,
                            world_size=args.world, timeout=timedelta(seconds=120))
    try:
        inputs = torch.load(args.inputs, weights_only=False)
        mesh = make_mesh(device="cpu")
        r = args.rank
        scenarios = {
            "shard_map": lambda: train_mode(inputs, mesh, "shard_map", r),
            "pjit": lambda: train_mode(inputs, mesh, "pjit", r),
            "eval": lambda: eval_mode(inputs, mesh, r),
            "generate": lambda: generate_mode(inputs, mesh, r),
            "tilers": lambda: tilers_mode(inputs, mesh, r),
            "halo": lambda: halo_mode(inputs, r),
            "trainer": lambda: trainer_mode(Path(args.out) / "trainer", mesh, r),
        }
        out, seconds = {}, {}
        for name, run in scenarios.items():
            t0 = time.perf_counter()
            out[name] = run()
            seconds[name] = time.perf_counter() - t0
        out["seconds"] = seconds
        torch.save(out, os.path.join(args.out, f"rank{r}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
