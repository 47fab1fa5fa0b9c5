"""The GAN training step and the validation step (port of ``skillful_nowcasting_tpu/training.py``).

One optimizer iteration of the reference (``training.py:429-712`` in JAX):

* **D phase**, 2 updates. Each draws a fresh generator sample (train mode,
  no gradient; it still advances the generator's BatchNorm and
  spectral-norm state), scores real||generated concatenated along the batch
  in one discriminator call (shared BatchNorm statistics), and steps D.
* **G phase.** ``generation_steps`` train-mode rollouts, each scored by the
  train-mode discriminator (its state advances, its parameters do not step).
  The loss is ``hinge_gen + grid_lambda * grid(mean of samples)``; one G
  step.
* **One logging forward** (quirk Q8), which advances the state again.

State lives where torch keeps it: parameters and BN/SN buffers in the
model, moments in the optimizers (:class:`TrainState`). Every BN/SN buffer
advances once per forward, as in JAX. With ``rollout_remat`` each G rollout
runs under ``torch.utils.checkpoint``; its recompute in the backward pass
replays the buffers the first pass found and writes nothing, so it
neither advances the state a second time nor computes the gradient with
other sigmas or statistics than the loss saw.

The step takes its randomness from a ``torch.Generator``, or from explicit
:class:`StepDraws` (a latent per generator forward, frame indices per
discriminator call). Opt-in, as in JAX: the R1 penalty on both D updates
(``r1_gamma``), mixed precision (``compute_dtype=torch.bfloat16``: bf16
inputs to every conv and matmul, f32 parameters, moments, gradients and
BN/SN state), and per-layer gradient norms and histograms
(``watch_gradients`` / ``watch_histograms``).

Data parallelism (JAX's ``axis_name``; see :mod:`.parallel.dp`): with a
process ``group`` every rank runs the step on its own rows of the batch and
the gradients are averaged over the group with one flat all-reduce after
each of the three ``_grads`` (the step never calls ``.backward()``, so
``DistributedDataParallel``'s hooks would never fire). By default each rank
draws its own latents and frames and keeps its own BatchNorm statistics,
and every floating BN/SN buffer is averaged at the step's end (torch-DDP
semantics, JAX's ``shard_map`` mode). ``global_batch=True`` is the
single-card step on the global batch (JAX's ``pjit`` mode): the same draws
on every rank and train-mode BatchNorm synchronised over the group. With a
``space`` layout it shards the fields' H as well (JAX's ``spatial_axis``):
every rank runs the step on its stripe of its rows, and the convs exchange
halos forward and backward (:mod:`.parallel.spatial`).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.optim.lr_scheduler import LambdaLR
from torch.utils.checkpoint import checkpoint

from .hub.convert import param_paths
from .logging_utils import HIST_BINS, HIST_Y_MAX
from .losses import GridCellLoss, loss_hinge_disc, loss_hinge_gen, weight_fn
from .models.common import DRAWS_NOT_SHARED, draw_latents
from .models.discriminators import draw_frames
from .ops.norm import sync_batch_norm

N_DISC_STEPS = 2


@dataclass
class TrainState:
    """Everything that evolves during training: the model and both optimizers."""

    model: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    g_sched: LambdaLR
    d_sched: LambdaLR
    step: int = 0


@dataclass
class StepDraws:
    """The random draws of one step, in the JAX step's key order (``training.py:450-455``).

    Latents are ``(1, 8C, H/32, W/32)``, frame indices ``(8,)`` integers.
    ``log_z`` (the logging forward's latent) is ``None`` in the eval step.
    """

    d_z: List[torch.Tensor]
    d_frames: List[torch.Tensor]
    g_z: List[torch.Tensor]
    g_frames: List[torch.Tensor]
    log_z: Optional[torch.Tensor] = None


def draw_step(
    model, seq_len: int, generator: Optional[torch.Generator] = None, logging_forward: bool = True
) -> StepDraws:
    """Draw one step's latents and spatial-discriminator frame indices (in ``[0, seq_len)``)."""
    like = next(model.parameters())
    n_gen = model.generation_steps
    n_frames = model.discriminator.spatial_discriminator.num_timesteps

    def z(n):
        return [draw_latents(model.latent_stack.shape, 1, generator, like) for _ in range(n)]

    def frames(n):
        return [draw_frames(n_frames, seq_len, generator) for _ in range(n)]

    return StepDraws(
        d_z=z(N_DISC_STEPS),
        d_frames=frames(N_DISC_STEPS),
        g_z=z(n_gen),
        g_frames=frames(n_gen),
        log_z=z(1)[0] if logging_forward else None,
    )


def split_params(model: nn.Module) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """The model's parameters by name: (generator, discriminator)."""
    g, d = {}, {}
    for name, p in model.named_parameters():
        (d if name.startswith("discriminator.") else g)[name] = p
    return g, d


def make_lr_schedule(base_lr: float, spec: Optional[str]) -> Callable[[int], float]:
    """An optax-equivalent schedule ``update count -> lr`` for an opt-in spec string.

    * ``None`` / ``"constant"``           -> ``base_lr`` (the reference)
    * ``"cosine:<steps>[:<alpha>]"``      -> cosine decay to ``alpha*base``
    * ``"exp:<steps>:<rate>"``            -> ``base * rate**(t/steps)``
    * ``"warmup_cosine:<warm>:<steps>[:<alpha>]"`` -> linear warmup from 0
      over ``warm`` steps, then cosine decay to ``alpha*base`` at ``steps``
    * ``"linear:<steps>[:<end_scale>]"``  -> linear to ``end_scale*base``
    """

    def cosine(init, steps, alpha):
        def f(count):
            c = min(count, steps)
            return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / steps)) + alpha)
        return f

    if spec is None or spec == "constant":
        return lambda count: base_lr
    kind, *args = spec.split(":")
    if kind == "cosine":
        return cosine(base_lr, int(args[0]), float(args[1]) if len(args) > 1 else 0.0)
    if kind == "exp":
        steps, rate = int(args[0]), float(args[1])
        return lambda count: base_lr if count <= 0 else base_lr * rate ** (count / steps)
    if kind == "warmup_cosine":
        warm, steps = int(args[0]), int(args[1])
        alpha = float(args[2]) if len(args) > 2 else 0.0
        decay = cosine(base_lr, steps - warm, alpha)
        return lambda count: base_lr * count / warm if count < warm else decay(count - warm)
    if kind == "linear":
        steps = int(args[0])
        end = (float(args[1]) if len(args) > 1 else 0.0) * base_lr
        return lambda count: (base_lr - end) * (1 - min(max(count, 0), steps) / steps) + end
    raise ValueError(f"unknown lr schedule spec: {spec!r}")


def make_optimizers(model) -> Tuple[torch.optim.Optimizer, torch.optim.Optimizer]:
    """Adam over the G and D parameters: the model's lrs and betas, eps 1e-8 (optax's formula)."""
    g, d = split_params(model)
    betas = (model.beta1, model.beta2)
    return (
        torch.optim.Adam(g.values(), lr=model.gen_lr, betas=betas, eps=1e-8),
        torch.optim.Adam(d.values(), lr=model.disc_lr, betas=betas, eps=1e-8),
    )


def lr_scheduler(opt: torch.optim.Optimizer, spec: Optional[str]) -> LambdaLR:
    """Drive ``opt``'s lr by :func:`make_lr_schedule` from its update count (step it after ``opt``).

    As with optax, the first update uses the schedule's value at count 0.
    The scheduler keeps ``spec`` (``.spec``): a JAX-format checkpoint holds a
    schedule's count only where the lr is not fixed.
    """
    base = opt.param_groups[0]["lr"]
    schedule = make_lr_schedule(base, spec)
    sched = LambdaLR(opt, lambda count: schedule(count) / base)
    sched.spec = spec
    return sched


def init_train_state(
    model,
    optimizers: Optional[Tuple[torch.optim.Optimizer, torch.optim.Optimizer]] = None,
    *,
    g_lr_schedule: Optional[str] = None,
    d_lr_schedule: Optional[str] = None,
) -> TrainState:
    """Wrap an initialized model with its optimizers and lr schedules.

    ``optimizers`` replaces :func:`make_optimizers`' Adam pair (for example
    SGD for equivalence tests, where Adam at ``beta1 = 0`` turns last-bit
    gradient differences into O(lr) steps). A torch optimizer carries its
    own state, so the override is given here once; the JAX package passes
    it to both ``init_train_state`` and ``make_train_step``.
    """
    g_opt, d_opt = optimizers if optimizers is not None else make_optimizers(model)
    return TrainState(
        model, g_opt, d_opt, lr_scheduler(g_opt, g_lr_schedule), lr_scheduler(d_opt, d_lr_schedule)
    )


@torch.no_grad()
def desaturate_discriminator(model, factor: float = 0.01):
    """Shrink both D heads' pre-classifier BatchNorm scale so the hinge terms are active.

    At random init the hinge can saturate (real scores >= 1, generated <= -1),
    which zeroes every D gradient and makes any check on D vacuous. The two
    BatchNorms are found by name under ``discriminator``; another count raises.
    """
    hits = [m for name, m in model.discriminator.named_modules() if name.split(".")[-1] == "bn"]
    if len(hits) != 2:
        raise KeyError(f"expected the 2 discriminator heads' 'bn' modules, found {len(hits)}")
    for bn in hits:
        bn.weight.mul_(factor)
    return model


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Upcast-only cast for losses and sums: bf16 -> f32, f64 stays f64 (``training.py:214``)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _split_scores(scores: torch.Tensor, n_real: int):
    """(2B, 2, 1) scores, at >= f32 -> real spatial, real temporal, generated spatial, generated temporal."""
    scores = _at_least_f32(scores)
    real, generated = scores[:n_real], scores[n_real:]
    return real[:, :1], real[:, 1:], generated[:, :1], generated[:, 1:]


def _r1_penalty(model, real_seq: torch.Tensor, gen_seq: torch.Tensor, frames, n_real: int,
                space=None):
    """R1 (``training.py:482-525`` in JAX): ``0.5 * mean_b ||d(sum of real scores)/dx||^2``.

    The penalty scores the real half of the same real||generated concat
    that the loss forward scored, with the same frame indices, so its
    BatchNorm statistics are the loss's. It is differentiated at the
    full-precision ``real_seq`` and runs at >= f32 whatever the compute
    dtype (a bf16 double backward through D's BN/SN towers gives NaN). Its
    forward starts from the state the loss forward left (one more power
    iteration, so its sigmas are not the loss's) and writes nothing: the
    discriminator's buffers are put back as that forward found them. No
    tensor of the autograd graph aliases a buffer, so putting them back
    leaves the double backward intact.

    Under ``space`` ``real_seq`` is this rank's stripe. The scores are the
    same on every rank of the space group, and the collectives' backward sums
    over the ranks (:mod:`.parallel.spatial`), so the input gradient comes out
    ``n_space`` times the score's and is divided back; its squares add up
    over the stripes.
    """
    buffers = dict(model.discriminator.named_buffers())
    kept = {k: b.clone() for k, b in buffers.items()}
    x = real_seq.detach().requires_grad_(True)
    try:
        scores = model.discriminate(torch.cat([x, _at_least_f32(gen_seq)]), frame_indices=frames,
                                    space=space)
    finally:
        with torch.no_grad():
            for k, b in buffers.items():
                b.copy_(kept[k])
    rs, rt, _, _ = _split_scores(scores, n_real)
    (gin,) = torch.autograd.grad(rs.sum() + rt.sum(), x, create_graph=True)
    sq = _at_least_f32(gin).square().reshape(n_real, -1).sum(dim=1)
    if space is not None:
        sq = space.sum(sq) / space.size**2
    return 0.5 * sq.mean()


def _layer_groups(model, names, depth: int, skip: int = 0) -> Dict[str, List[str]]:
    """Parameter names grouped by their JAX param-tree path cut to ``depth`` levels.

    ``skip`` drops that many leading levels first (1 for the discriminator's
    own tree). Paths come from :func:`~.hub.convert.param_paths`, so the
    keys are the JAX step's (``training.py:242-315``).
    """
    paths = param_paths(model)
    groups: Dict[str, List[str]] = {}
    for name in sorted(names, key=lambda n: paths[n]):
        groups.setdefault("/".join(paths[name][skip : skip + depth]), []).append(name)
    return groups


def _layer_grad_norms(model, grads, prefix: str, skip: int = 0) -> Dict[str, torch.Tensor]:
    """Gradient norm per layer path, two levels deep (``_layer_grad_norms`` in JAX)."""
    return {
        prefix + key: _global_norm({n: grads[n] for n in names})
        for key, names in _layer_groups(model, grads, 2, skip).items()
    }


def _histogram(values: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Symlog histogram of ``values`` as f32: 64 integer counts, min, max, sum, sum of squares.

    The bin of ``v`` is ``floor((clip(asinh(v / 1e-12) / ln 10, +-28) + 28) / 0.875)``,
    computed with the operations of the JAX step's compiled program: each
    division by a constant is a product with its f32 reciprocal, and asinh
    is ``sign(x) log1p(|x| + x^2 / (sqrt(x^2 + 1) + 1))`` (``log|x| + ln 2``
    from ``|x| >= 2^64``). So an element lands in the JAX step's bin unless
    it sits within the last bit of XLA's and torch's f32 ``log`` / ``log1p``
    from a bin edge. An integer bincount: a float bin would saturate at 2^24
    (``training.py:289-296``).
    """
    v = torch.cat([t.detach().reshape(-1).float() for t in values])
    f32 = lambda c: torch.tensor(c, dtype=torch.float32, device=v.device)  # noqa: E731
    x = v * f32(1e12)
    a, xx = x.abs(), x * x
    asinh = torch.where(a >= f32(2.0**64), torch.log(a) + f32(math.log(2.0)),
                        torch.log1p(a + xx / (torch.sqrt(xx + 1.0) + 1.0)))
    y = (torch.sign(x) * asinh * f32(1.0 / math.log(10.0))).clamp(-HIST_Y_MAX, HIST_Y_MAX)
    idx = ((y + HIST_Y_MAX) * f32(HIST_BINS / (2.0 * HIST_Y_MAX))).to(torch.int32)
    counts = torch.bincount(idx.clamp(0, HIST_BINS - 1), minlength=HIST_BINS)
    return {"counts": counts.to(torch.int32), "min": v.min(), "max": v.max(),
            "sum": v.sum(), "sumsq": (v * v).sum()}


def _layer_histograms(model, tensors, prefix: str, depth: int = 2, skip: int = 0):
    """One :func:`_histogram` per layer path (``_layer_histograms`` in JAX)."""
    return {
        prefix + key: _histogram([tensors[n] for n in names])
        for key, names in _layer_groups(model, tensors, depth, skip).items()
    }


def _generator_buffers(model) -> Dict[str, torch.Tensor]:
    mods = (model.conditioning_stack, model.latent_stack, model.sampler)
    return {f"{i}.{k}": b for i, mod in enumerate(mods) for k, b in mod.named_buffers()}


def _replay_generator_state(model):
    """``context_fn`` of a rollout's checkpoint: its recompute replays the generator's
    buffers (BN running stats, SN ``u``/``v``) as the first pass found them, and
    restores them as they are afterwards, so the recompute writes nothing."""
    found: Dict[str, torch.Tensor] = {}

    def copy_into(bufs, values):
        with torch.no_grad():
            for k, b in bufs.items():
                b.copy_(values[k])

    @contextlib.contextmanager
    def first_pass():
        found.update({k: b.clone() for k, b in _generator_buffers(model).items()})
        yield

    @contextlib.contextmanager
    def recompute():
        bufs = _generator_buffers(model)
        now = {k: b.clone() for k, b in bufs.items()}
        copy_into(bufs, found)
        try:
            yield
        finally:
            copy_into(bufs, now)

    return first_pass(), recompute()


def _grads(loss, params: Dict[str, nn.Parameter]) -> Dict[str, torch.Tensor]:
    """d loss / d params, zeros for parameters off the graph (the unused shortcut convs)."""
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {
        k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)
    }


def _apply(opt, sched, params, grads) -> None:
    for k, p in params.items():
        p.grad = grads[k]
    opt.step()
    opt.zero_grad(set_to_none=True)
    sched.step()


def _global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(g.pow(2).sum() for g in grads.values()))


def _check_group(model, group) -> None:
    """An NCCL group takes CUDA tensors only: a CPU model on one raises here, not in NCCL."""
    if group is None:
        return
    import torch.distributed as dist

    if dist.get_backend(group) == "nccl" and next(model.parameters()).device.type != "cuda":
        raise ValueError("a model on the CPU cannot run on an NCCL group")


def rank_generator(generator: Optional[torch.Generator], group) -> torch.Generator:
    """This rank's generator for one step: JAX's ``fold_in(rng, axis_index)``.

    Draws one integer from ``generator`` (the same on every rank that holds
    the same generator) and seeds a new generator on its device from that
    integer and the rank in ``group``.
    """
    import torch.distributed as dist

    device = generator.device if generator is not None else torch.device("cpu")
    seed = int(torch.randint(0, 2**63 - 1, (), generator=generator, device=device))
    mixed = np.random.SeedSequence([seed, dist.get_rank(group)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def _check_space(space, global_batch: bool) -> None:
    if space is not None and not global_batch:
        raise ValueError("an H-sharded step is a global-batch step: pass global_batch=True "
                         "(the shard_map mode has no halos)")


def _global_batch_scale(group, global_batch: bool) -> int:
    """The grid loss sums over the batch (quirk Q3): on the global batch it is the ranks' sum, so
    each rank's term counts ``n`` times before the average over ``n`` ranks (a stripe's term,
    its share of the field's, as well)."""
    if group is None or not global_batch:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def _average(tensors, group) -> None:
    """Average ``tensors`` over ``group`` in place (one flat all-reduce per dtype); no-op without one."""
    if group is not None:
        from .parallel.mesh import all_reduce_mean_

        all_reduce_mean_(list(tensors), group)


@contextlib.contextmanager
def _mode(model, training: bool):
    """Run the block with ``model`` in train (or eval) mode, and restore its mode after."""
    was_training = model.training
    model.train(training)
    try:
        yield
    finally:
        model.train(was_training)


def _batches(model, images, future_images, compute_dtype):
    """On the model's device: the model's input in ``compute_dtype``, the target at >= f32,
    and the real sequence at >= f32 and in ``compute_dtype`` (``training.py:430-445``)."""
    dev = next(model.parameters()).device
    images, future_images = images.to(dev), _at_least_f32(future_images.to(dev))
    real_seq = torch.cat([_at_least_f32(images), future_images], dim=1)
    return images.to(compute_dtype), future_images, real_seq, real_seq.to(compute_dtype)


def _draws(model, seq_len, generator, draws, group, global_batch, logging_forward):
    """The step's draws: given, or drawn from ``generator`` (per rank in the shard_map mode).

    A global-batch step on more than one rank refuses to draw from each
    process's own global RNG: every rank must compute with the same draws.
    """
    if draws is not None:
        return draws
    if group is not None and not global_batch:
        generator = rank_generator(generator, group)
    elif group is not None and generator is None:
        raise ValueError(DRAWS_NOT_SHARED)
    return draw_step(model, seq_len, generator, logging_forward)


def _field_height(images: torch.Tensor, space) -> Optional[int]:
    """The field's H where ``images`` hold this rank's stripe of it (``None`` without a layout)."""
    return None if space is None else images.shape[-2] * space.size


def _compute_dtype(model, compute_dtype: Optional[torch.dtype]) -> torch.dtype:
    """``None`` means the parameters' dtype (float32, or float64 for a ``.double()`` model)."""
    return compute_dtype or next(model.parameters()).dtype


def make_train_step(
    model,
    *,
    logging_forward: bool = True,
    watch_gradients: bool = False,
    watch_histograms: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    return_grads: bool = False,
    rollout_remat: bool = True,
    r1_gamma: float = 0.0,
    group=None,
    global_batch: bool = False,
    space=None,
    batch_group=None,
):
    """Build ``train_step(state, images, future_images, generator=None, draws=None) -> metrics``.

    Batches are NTCHW, moved to the model's device. The step updates
    ``state`` in place (parameters, buffers, optimizers, ``step``) and
    returns the six ``train/*`` scalars; with ``return_grads`` also
    ``g_grads`` (name -> tensor) and ``d_grads`` (name -> the two D steps'
    gradients stacked). ``logging_forward=False`` drops the reference's unused
    extra generator forward (quirk Q8). ``rollout_remat`` recomputes each G
    rollout in the backward pass instead of keeping its activations.

    ``r1_gamma > 0`` adds ``r1_gamma`` times the R1 penalty
    (:func:`_r1_penalty`) to both D losses and reports the last one as
    ``train/d_r1``. ``compute_dtype`` (``None``: the parameters' dtype) is
    the dtype of every conv and matmul input; ``torch.bfloat16`` is mixed
    precision: parameters, Adam moments, gradients, BN statistics and SN
    vectors stay in the parameters' dtype, the grid-loss target, the sum of
    the samples, the scores and the losses are at least f32.
    ``watch_gradients`` adds each layer path's gradient norm, two levels deep
    (``train/grad_norm/<path>``, D's under ``train/grad_norm/discriminator/``);
    ``watch_histograms`` adds ``metrics["train/hist"]``, per layer path the
    symlog histogram (:func:`_histogram`) of the post-step parameters, the
    G gradients and the last D step's gradients. Keys follow the JAX step's
    param-tree paths.

    ``group`` (a ``torch.distributed`` process group; JAX's ``axis_name``)
    makes the step data-parallel over the group's ranks, each passing its own
    rows of the batch. The gradients are averaged after each of the three
    updates' backward passes (one flat all-reduce each), so the norms, the
    watched gradients and ``return_grads`` are the averaged ones; the six
    ``train/*`` losses and ``train/d_r1`` are averaged at the end. Without
    explicit ``draws`` each rank draws from :func:`rank_generator` of
    ``generator``; each rank normalizes with its own BatchNorm statistics,
    and every floating BN/SN buffer is averaged over the group at the step's
    end (no renormalisation of ``u`` / ``v``), as JAX's ``shard_map`` mode
    does. ``global_batch=True`` is JAX's ``pjit`` mode, the single-card step
    on the global batch: every rank draws from ``generator`` itself (pass
    the same one), train-mode BatchNorm is synchronised over the group
    (:func:`~.ops.norm.sync_batch_norm`), and the buffers stay equal with
    no averaging. The grid loss, a sum over the batch, counts ``n`` times on
    each of the ``n`` ranks, so with equal local batches the averaged losses
    and gradient are the global batch's. Every rank must call the step the
    same way, and a global-batch step without ``draws`` or ``generator``
    raises ``ValueError``.

    ``space`` (a :class:`~.parallel.spatial.SpaceLayout`; global batch only)
    is JAX's ``spatial_axis``: ``images`` / ``future_images`` are this rank's
    stripe of its rows, ``group`` spans every rank of the mesh and
    ``batch_group`` (read only with ``space``) the ranks of the other batch
    rows (the mesh's data axis; ``None`` where it is 1). The generator's
    BatchNorms synchronise over ``group``; the discriminator heads', whose
    inputs every rank of a space group holds alike after the stripes' sum,
    over ``batch_group``. The
    gradients, the losses and the buffers come out the dense step's on the
    global batch, and the same on every rank.
    """
    grid_loss = GridCellLoss(weight_fn=weight_fn, precip_weight_cap=model.precip_weight_cap)
    n_gen = model.generation_steps
    compute_dtype = _compute_dtype(model, compute_dtype)
    _check_group(model, group)
    _check_space(space, global_batch)
    grid_scale = _global_batch_scale(group, global_batch)
    per_rank = group is not None and not global_batch
    head_group = batch_group if space is not None else group

    def train_step(state: TrainState, images, future_images, generator=None, draws=None):
        mdl = state.model
        images, future_images, real_seq, real_seq_c = _batches(
            mdl, images, future_images, compute_dtype)
        draws = _draws(mdl, real_seq.shape[1], generator, draws, group, global_batch,
                       logging_forward)
        b = images.shape[0]
        g_params, d_params = split_params(mdl)
        sync = sync_batch_norm(mdl, group if global_batch else None)
        sync_heads = sync_batch_norm(mdl.discriminator, head_group if global_batch else None)
        with sync, sync_heads, _mode(mdl, True):
            d_losses, d_grads, d_r1 = [], [], []
            for z, frames in zip(draws.d_z, draws.d_frames):
                with torch.no_grad():
                    preds = mdl(images, z=z, space=space)
                gen_seq = torch.cat([images, preds], dim=1)
                concat = torch.cat([real_seq_c, gen_seq], dim=0)
                rs, rt, gs, gt = _split_scores(
                    mdl.discriminate(concat, frame_indices=frames, space=space), b)
                loss = loss_hinge_disc(gs, rs) + loss_hinge_disc(gt, rt)
                if r1_gamma > 0.0:
                    r1 = _r1_penalty(mdl, real_seq, gen_seq, frames, b, space)
                    loss = loss + r1_gamma * r1
                    d_r1.append(r1.detach())
                grads = _grads(loss, d_params)
                _average(grads.values(), group)
                _apply(state.d_opt, state.d_sched, d_params, grads)
                d_losses.append(loss.detach())
                d_grads.append(grads)

            def rollout(z):
                return mdl(images, z=z, space=space)

            sum_preds, gen_scores = 0.0, []
            for z, frames in zip(draws.g_z, draws.g_frames):
                if rollout_remat:
                    preds = checkpoint(
                        rollout, z, use_reentrant=False,
                        context_fn=lambda: _replay_generator_state(mdl),
                    )
                else:
                    preds = rollout(z)
                concat = torch.cat([real_seq_c, torch.cat([images, preds], dim=1)], dim=0)
                gen_scores.append(mdl.discriminate(concat, frame_indices=frames, space=space)[b:])
                sum_preds = sum_preds + _at_least_f32(preds)
            grid = grid_loss(sum_preds / n_gen, future_images, _field_height(images, space))
            if grid_scale != 1:
                grid = grid * grid_scale
            g_disc_loss = loss_hinge_gen(_at_least_f32(torch.stack(gen_scores)))
            g_loss = g_disc_loss + mdl.grid_lambda * grid
            g_grads = _grads(g_loss, g_params)
            _average(g_grads.values(), group)
            _apply(state.g_opt, state.g_sched, g_params, g_grads)

            generated = None
            if logging_forward:
                with torch.no_grad():
                    generated = mdl(images, z=draws.log_z, space=space)
        if per_rank:  # replica-consistent state
            _average([t for t in mdl.buffers() if t.is_floating_point()], group)
        state.step += 1

        metrics = {
            "train/d_loss": d_losses[-1],
            "train/g_loss": g_loss.detach(),
            "train/grid_loss": grid.detach(),
            "train/g_disc_loss": g_disc_loss.detach(),
            "train/g_grad_norm": _global_norm(g_grads),
            "train/d_grad_norm": _global_norm(d_grads[-1]),
        }
        if r1_gamma > 0.0:
            metrics["train/d_r1"] = d_r1[-1]
        # The losses, not the norms: those of the averaged gradients are equal on every rank.
        _average([v for k, v in metrics.items() if not k.endswith("grad_norm")], group)
        if watch_gradients:
            metrics.update(_layer_grad_norms(mdl, g_grads, "train/grad_norm/"))
            metrics.update(_layer_grad_norms(
                mdl, d_grads[-1], "train/grad_norm/discriminator/", skip=1))
        if watch_histograms:
            params = dict(mdl.named_parameters())
            metrics["train/hist"] = {
                **_layer_histograms(mdl, params, "train/hist/params/"),
                **_layer_histograms(mdl, g_grads, "train/hist/grads/"),
                **_layer_histograms(mdl, d_grads[-1], "train/hist/grads/discriminator/",
                                    depth=1, skip=1),
            }
        if return_grads:
            metrics["g_grads"] = g_grads
            metrics["d_grads"] = {k: torch.stack([g[k] for g in d_grads]) for k in d_params}
        if mdl.visualize and generated is not None:
            metrics["train/generated_images"] = generated
        return metrics

    return train_step


def make_eval_step(model, *, compute_dtype: Optional[torch.dtype] = None, group=None,
                   global_batch: bool = False, space=None):
    """Build ``eval_step(state, images, future_images, generator=None, draws=None) -> metrics``.

    The validation step (``training.py:731-802`` in JAX): the same losses
    with the model in eval mode (the hand-written kernels on the card),
    no gradients and no updates. Two D evaluations, each on a fresh sample
    (``val/d_loss`` is the last, ``val/d_loss_first`` the first), then
    ``generation_steps`` samples for the grid loss and the generator hinge.
    ``compute_dtype`` as in :func:`make_train_step`: a bf16 step runs the
    kernels' bf16 variants; the mean of the samples and the losses are at
    least f32. ``group`` and ``global_batch`` as in :func:`make_train_step`:
    per-rank draws (or, with ``global_batch``, the same draws on every rank)
    and the metrics averaged over the group; ``space`` as there (the
    discriminators' eval BatchNorms take no group).
    """
    grid_loss = GridCellLoss(weight_fn=weight_fn, precip_weight_cap=model.precip_weight_cap)
    compute_dtype = _compute_dtype(model, compute_dtype)
    _check_group(model, group)
    _check_space(space, global_batch)
    grid_scale = _global_batch_scale(group, global_batch)

    @torch.no_grad()
    def eval_step(state: TrainState, images, future_images, generator=None, draws=None):
        mdl = state.model
        images, future_images, real_seq, real_seq_c = _batches(
            mdl, images, future_images, compute_dtype)
        draws = _draws(mdl, real_seq.shape[1], generator, draws, group, global_batch, False)
        b = images.shape[0]

        def score(z, frames):
            preds = mdl(images, z=z, space=space)
            concat = torch.cat([real_seq_c, torch.cat([images, preds], dim=1)], dim=0)
            return preds, mdl.discriminate(concat, frame_indices=frames, space=space)

        with _mode(mdl, False):
            d_losses = []
            for z, frames in zip(draws.d_z, draws.d_frames):
                rs, rt, gs, gt = _split_scores(score(z, frames)[1], b)
                d_losses.append(loss_hinge_disc(gs, rs) + loss_hinge_disc(gt, rt))
            preds, scores = zip(*(score(z, f) for z, f in zip(draws.g_z, draws.g_frames)))
        grid = grid_loss(_at_least_f32(torch.stack(preds)).mean(dim=0), future_images,
                         _field_height(images, space))
        if grid_scale != 1:
            grid = grid * grid_scale
        gen_scores = _at_least_f32(torch.stack([s[b:] for s in scores]))
        g_loss = loss_hinge_gen(gen_scores) + mdl.grid_lambda * grid
        metrics = {
            "val/d_loss": d_losses[-1],
            "val/g_loss": g_loss,
            "val/grid_loss": grid,
            "val/d_loss_first": d_losses[0],
        }
        _average(metrics.values(), group)
        return metrics

    return eval_step
