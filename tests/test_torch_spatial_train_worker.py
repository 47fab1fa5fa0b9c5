"""One rank of the port's H-sharded train and eval checks on the CPU: ``python tests/test_torch_spatial_train_worker.py``.

``tests/test_torch_spatial_train.py`` starts four of these processes
(``gloo``, one thread each) on an inputs file it wrote. It imports torch and
the port only, never JAX, and holds no tests. Each rank writes
``rank<r>.pt`` into the output directory: rank 0 of a mesh the tensors the
test compares, every rank its own checks.

The four ranks first form a ``(data=2, space=2)`` mesh (``"quad"``), then
two ``(data=1, space=2)`` meshes of ranks 0-1 (``"pair"``) and 2-3
(``"pair_b"``). The quad and the pair each run one float64 SGD train step
of the tiny DGMR with explicit draws through ``make_dp_train_step(mode="pjit",
spatial_axis="space")``, on this rank's stripe of its rows, without and with
R1 and both watch flags; the quad also runs ``eval``, the float32 ``pjit``
eval step on stripes (and the kernel launches of its forwards). The second
pair runs:

* ``layers``: float64 checks against the dense layer on the whole field: the
  autograd halo (a 2-D and a 3-D conv, forward and backward), a
  ``gradcheck`` / ``gradgradcheck`` of the halo and the gather, the
  thin-level gather and its backward, and the sharded train forward;
* ``draws``: with the global RNGs advanced differently on each rank, the
  sharded forward, the ``pjit`` train step (data axis and space axis) and
  the ``pjit`` eval step without draws raise; with an equally seeded
  generator the sharded forward and the data-axis ``pjit`` step equal the
  dense ones on the same rows;
* ``trainer``: ``Trainer(mesh=(1, 2), dp_mode="pjit", spatial_axis="space")``
  for two float64 SGD steps with validation and the skill metrics.

Rank 0 then runs that Trainer on a mesh of one (``"one"``), the comparison.
"""

from __future__ import annotations

import argparse
import copy
import json
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

from skillful_nowcasting_tpu_torch import DGMR, training  # noqa: E402
from skillful_nowcasting_tpu_torch.data import synthetic_radar_batches  # noqa: E402
from skillful_nowcasting_tpu_torch.ops import convgru_rollout, gblock_fused  # noqa: E402
from skillful_nowcasting_tpu_torch.ops.norm import sum_over_ranks  # noqa: E402
from skillful_nowcasting_tpu_torch.parallel import (  # noqa: E402
    Mesh,
    SpaceLayout,
    gather_rows,
    halo_exchange,
    make_dp_eval_step,
    make_dp_train_step,
    make_mesh,
    make_spatial_forward,
    reset_halo_counters,
    shard_batch,
)
from skillful_nowcasting_tpu_torch.trainer import Trainer  # noqa: E402
from skillful_nowcasting_tpu_torch.utils import random_fill  # noqa: E402

LR = (5e-5, 2e-4)  # SGD for G, D
R1_GAMMA = 10.0  # the R1 reference's
# The Trainer's model: the smallest the paper's towers take on a field two space ranks share.
SMALL = dict(forecast_steps=2, output_shape=64, latent_channels=256, context_channels=32,
             generation_steps=1, num_samples=2, num_spatial_layers=1, num_temporal_layers=1)
# The draws scenario's data-axis step: the smallest field the towers take.
SMALLER = dict(SMALL, output_shape=32)


def model_from(inputs, dtype):
    model = DGMR(**inputs["config"], device="cpu")
    model.load_state_dict(inputs["state_dict"], strict=True)
    return model.to(dtype)


def sgd_state(model):
    g, d = training.split_params(model)
    return training.init_train_state(
        model, (torch.optim.SGD(g.values(), lr=LR[0]), torch.optim.SGD(d.values(), lr=LR[1])))


def replicas_equal(model, group) -> bool:
    """Every rank's parameters and buffers, bit for bit (gathered, compared on every rank)."""
    flat = torch.cat([t.detach().reshape(-1).double() for t in model.state_dict().values()])
    rows = gather_rows(flat, group)
    return bool((rows == rows[0]).all())


def pair_meshes(group, rank: int) -> tuple:
    """The ``(data=1, space=2)`` and ``(data=2, space=1)`` meshes of a two-rank ``group``."""
    cpu = torch.device("cpu")
    return (Mesh({"data": 1, "space": 2}, rank, cpu, group, None, group),
            Mesh({"data": 2, "space": 1}, rank, cpu, group, group, None))


def relative(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def states_relative(got, want) -> float:
    """The worst of max|got - want| / max(max|want|, 1e-6 of the largest), per floating tensor.

    The floor: a conv bias in front of a train-mode BatchNorm has a true
    gradient of 0, and its update is rounding noise.
    """
    want = {k: v for k, v in want.state_dict().items() if v.is_floating_point()}
    got = got.state_dict()
    top = max(v.abs().max().item() for v in want.values())
    return max(((got[k] - v).abs().max() / max(v.abs().max().item(), 1e-6 * top)).item()
               for k, v in want.items())


def floats(tree):
    """float32 copies: the comparison with JAX is at 1e-3 of each tensor (histograms stay)."""
    if isinstance(tree, dict):
        return {k: floats(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def train_step(inputs, mesh, r1: bool) -> dict:
    """One float64 SGD step on this rank's stripe of its rows; rank 0 keeps the trees."""
    model = model_from(inputs, torch.float64)
    kw = dict(r1_gamma=R1_GAMMA, watch_gradients=True, watch_histograms=True) if r1 else {}
    step = make_dp_train_step(model, mesh, mode="pjit", spatial_axis="space",
                              logging_forward=False, return_grads=True, **kw)
    x, y = shard_batch((inputs["x"].double(), inputs["y"].double()), mesh, spatial_axis="space")
    reset_halo_counters()
    t0 = time.perf_counter()
    metrics = step(sgd_state(model), x, y, draws=training.StepDraws(**inputs["draws"]["train"]))
    out = {"equal": replicas_equal(model, mesh.group), "seconds": time.perf_counter() - t0,
           "forward_exchanges": halo_exchange.calls,
           "backward_exchanges": halo_exchange.backward_calls}
    if mesh.rank == 0:
        out.update(
            metrics={k: v for k, v in metrics.items() if k.startswith("train/") and k !=
                     "train/hist"},
            hist=metrics.get("train/hist"),
            g_grads=floats(metrics["g_grads"]),
            d_grads=floats(metrics["d_grads"]),
            state={k: v.float() for k, v in model.state_dict().items()
                   if not k.endswith("num_batches_tracked")},
        )
    return out


def layers(mesh) -> dict:
    """Float64 checks of the autograd collectives and the sharded train forward."""
    group, rank, world = mesh.group, mesh.space_rank, mesh.shape["space"]
    space = SpaceLayout(group, rank)
    gen = torch.Generator().manual_seed(7)  # the same tensors on every rank

    def rows(t, each):
        return t[..., rank * each:(rank + 1) * each, :]

    out = {}
    # A 2-D and a 3-D SAME conv on stripes of 4 rows: output, d/dx and d/dw against the dense conv.
    for name, shape, w_shape, conv in (
            ("conv2d", (2, 3, 4 * world, 5), (4, 3, 3, 3), torch.nn.functional.conv2d),
            ("conv3d", (2, 3, 3, 4 * world, 5), (4, 3, 3, 3, 3), torch.nn.functional.conv3d)):
        x = torch.randn(shape, generator=gen, dtype=torch.float64, requires_grad=True)
        w = torch.randn(w_shape, generator=gen, dtype=torch.float64, requires_grad=True)
        cot = torch.randn((*shape[:1], w_shape[0], *shape[2:]), generator=gen,
                          dtype=torch.float64)
        dense = conv(x, w, padding=1)
        gx, gw = torch.autograd.grad((dense * cot).sum(), (x, w))
        xs = rows(x.detach(), 4).requires_grad_(True)
        ws = w.detach().requires_grad_(True)
        mine = space.conv(xs, ws, padding=1)
        gxs, gws = torch.autograd.grad((mine * rows(cot, 4)).sum(), (xs, ws))
        gws = sum_over_ranks(gws, group)  # every rank's share of d/dw
        out[name] = max(relative(mine, rows(dense, 4)), relative(gxs, rows(gx, 4)),
                        relative(gws, gw))
    # The thin-level gather: the whole field on every rank, and its backward the rows' share.
    x = torch.randn((2, 3, world, 5), generator=gen, dtype=torch.float64, requires_grad=True)
    cot = torch.randn((2, 3, world, 5), generator=gen, dtype=torch.float64)
    xs = rows(x.detach(), 1).requires_grad_(True)
    whole = space.gather(xs)
    (gxs,) = torch.autograd.grad((whole * cot).sum(), xs)
    out["gather"] = max(relative(whole, x.detach()), relative(gxs, world * rows(cot, 1)))
    # gradcheck / gradgradcheck of the halo and the gather as one function of the whole field,
    # identical on every rank: an input and an output mean over the ranks make each rank's
    # derivative the whole function's (the collectives' backward sums every rank's share).
    def mean(t):
        return sum_over_ranks(t, group) / world

    def halo_then_gather(field):
        return mean(space.gather(halo_exchange(rows(mean(field), 2), 2, group)))

    field = torch.randn((1, 1, 2 * world, 2), generator=gen, dtype=torch.float64,
                        requires_grad=True)
    torch.manual_seed(11)  # gradgradcheck draws its grad_outputs: the same on every rank
    out["gradcheck"] = bool(torch.autograd.gradcheck(halo_then_gather, (field,),
                                                     raise_exception=False))
    out["gradgradcheck"] = bool(torch.autograd.gradgradcheck(halo_then_gather, (field,),
                                                             raise_exception=False))
    # The exchanges count their forward and backward calls apart.
    reset_halo_counters()
    torch.autograd.grad(halo_exchange(rows(field, 2), 1, group).sum(), field)
    out["counts"] = (halo_exchange.calls, halo_exchange.backward_calls)
    # The sharded train forward (BatchNorm over the mesh) against the dense train forward.
    model = random_fill(DGMR(**SMALL, device="cpu"), torch.Generator().manual_seed(3)).double()
    x = torch.rand((2, 4, 1, 64, 64), generator=gen, dtype=torch.float64)
    z = torch.randn((1, 8, 2, 2), generator=gen, dtype=torch.float64)
    dense_model = copy.deepcopy(model)
    y = make_spatial_forward(model.train(), mesh)(x, z=z)
    want = dense_model.train()(x, z=z)
    out["train_forward"] = max(relative(y, rows(want, 64 // world)),
                               states_relative(model, dense_model))
    return out


def draws(space_mesh, data_mesh) -> dict:
    """The draw-sharing rule: differently advanced global RNGs raise; a shared seed agrees."""
    rank = space_mesh.space_rank
    torch.randn(rank + 1)  # each rank's global RNG now stands elsewhere
    out = {}
    model = random_fill(DGMR(**SMALL, device="cpu"), torch.Generator().manual_seed(4)).double()
    x = torch.rand((2, 4, 1, 64, 64), generator=torch.Generator().manual_seed(5),
                   dtype=torch.float64)
    y = torch.rand((2, 2, 1, 64, 64), generator=torch.Generator().manual_seed(6),
                   dtype=torch.float64)
    xs, ys = shard_batch((x, y), space_mesh, spatial_axis="space")
    state = sgd_state(model)
    calls = {
        "forward": lambda: make_spatial_forward(model.eval(), space_mesh)(x),
        "space_train_step": lambda: make_dp_train_step(
            model, space_mesh, mode="pjit", spatial_axis="space")(state, xs, ys),
        "space_eval_step": lambda: make_dp_eval_step(
            model, space_mesh, mode="pjit", spatial_axis="space")(state, xs, ys),
        "data_train_step": lambda: make_dp_train_step(model, data_mesh, mode="pjit")(
            state, *shard_batch((x, y), data_mesh)),
    }
    for name, call in calls.items():
        try:
            call()
            out[name] = "no error"
        except ValueError as e:
            out[name] = str(e)
    with torch.no_grad():
        seeded = make_spatial_forward(model.eval(), space_mesh)(
            x, generator=torch.Generator().manual_seed(8))
        dense = model(x, generator=torch.Generator().manual_seed(8))
    out["forward_vs_dense"] = relative(seeded, dense[..., rank * 32:(rank + 1) * 32, :])
    # The data-axis pjit step with one seeded generator on every rank = the dense B=2 step.
    small = random_fill(DGMR(**SMALLER, device="cpu"), torch.Generator().manual_seed(9))
    small = training.desaturate_discriminator(small).double()
    dense_model = copy.deepcopy(small)
    x, y = x[..., :32, :32], y[..., :32, :32]
    got = make_dp_train_step(small, data_mesh, mode="pjit", logging_forward=False)(
        sgd_state(small), *shard_batch((x, y), data_mesh), torch.Generator().manual_seed(10))
    want = training.make_train_step(dense_model, logging_forward=False)(
        sgd_state(dense_model), x, y, torch.Generator().manual_seed(10))
    out["step_vs_dense"] = max(abs(got[k].item() - want[k].item()) / abs(want[k].item())
                               for k in want)
    out["step_state_vs_dense"] = states_relative(small, dense_model)
    return out


def eval_step(inputs, mesh) -> dict:
    model = model_from(inputs, torch.float32)
    x, y = shard_batch((inputs["x"], inputs["y"]), mesh, spatial_axis="space")
    step = make_dp_eval_step(model, mesh, mode="pjit", spatial_axis="space")
    convgru_rollout.launches = gblock_fused.launches = 0
    got = step(training.init_train_state(model), x, y,
               draws=training.StepDraws(**inputs["draws"]["eval"]))
    return {"metrics": {k: v.item() for k, v in got.items()},
            "launches": convgru_rollout.launches + gblock_fused.launches}


def trainer(root: Path, mesh) -> dict:
    """Two float64 SGD steps with validation and the (float32) skill metrics; the logged lines."""
    model = random_fill(DGMR(**SMALL, device="cpu"), torch.Generator().manual_seed(12))
    model = training.desaturate_discriminator(model).double()
    data = synthetic_radar_batches(batch_size=1, target_frames=2, size=64, seed=30)
    val = synthetic_radar_batches(batch_size=1, target_frames=2, size=64, seed=31)
    t = Trainer(model, max_steps=2, log_dir=str(root), log_every=1, val_every=2, val_skill=True,
                logging_forward=False, prefetch=0, seed=5, mesh=mesh, dp_mode="pjit",
                spatial_axis="space" if mesh.size > 1 else None)
    # SGD: Adam at beta1 = 0 turns the rounding noise of a zero gradient (a conv bias in front
    # of a train-mode BatchNorm) into a step of lr / sqrt(1 - beta2) of either sign, which the
    # eval-mode validation sees.
    t.fit((tuple(torch.as_tensor(a).double() for a in b) for b in data),
          (tuple(torch.as_tensor(a).double() for a in b) for b in val),
          init_state=sgd_state(model))
    if mesh.rank:
        return {}
    with open(root / "metrics.jsonl") as f:
        return {"lines": [json.loads(line) for line in f]}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--inputs", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.port}", rank=args.rank,
                            world_size=4, timeout=timedelta(seconds=240))
    try:
        inputs = torch.load(args.inputs, weights_only=False)
        r = args.rank
        quad = make_mesh(2, n_space=2, device="cpu")
        pair_group, _ = dist.new_subgroups_by_enumeration([[0, 1], [2, 3]])
        pair, data_pair = pair_meshes(pair_group, r % 2)
        stages = {"quad": {"train": lambda: train_step(inputs, quad, r1=False),
                           "train_r1": lambda: train_step(inputs, quad, r1=True),
                           "eval": lambda: eval_step(inputs, quad)}}
        if r < 2:
            stages["pair"] = {"train": lambda: train_step(inputs, pair, r1=False),
                              "train_r1": lambda: train_step(inputs, pair, r1=True)}
            if r == 0:
                stages["one"] = {"trainer": lambda: trainer(Path(args.out) / "trainer_one",
                                                            make_mesh(1, device="cpu"))}
        else:
            stages["pair_b"] = {
                "layers": lambda: layers(pair),
                "draws": lambda: draws(pair, data_pair),
                "trainer": lambda: trainer(Path(args.out) / "trainer_space", pair)}
        out, seconds = {}, {}
        for stage, scenarios in stages.items():
            for name, run in scenarios.items():
                t0 = time.perf_counter()
                out.setdefault(stage, {})[name] = run()
                seconds[f"{stage}/{name}"] = time.perf_counter() - t0
        out["seconds"] = seconds
        torch.save(out, os.path.join(args.out, f"rank{r}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
