"""Ensemble generation, paper skill metrics and giant-field nowcasts.

Port of ``skillful_nowcasting_tpu/inference.py``:

* :func:`make_generate`: an S-sample ensemble of nowcasts;
* :func:`make_skill_metrics` / :func:`evaluate_nowcast`: fair CRPS (grid
  and pooled), CSI from pooled contingency counts and ensemble-mean MSE
  over a batch iterator, computed on the model's device;
* :func:`tiled_nowcast` (host-streaming) and :func:`tiled_nowcast_device`
  (device-resident): sliding-window nowcasts of a radar field of any size,
  such as MRMS CONUS (3500x7000), with overlap-and-crop stitching.

The model's latent grid is tied to its ``output_shape``, so a field larger
than a tile has no single forward; tiling defines the giant-field
semantics: each tile is an exact model forward, every tile shares one
latent (quirk Q2 extended to the domain), and interior seams crop
``overlap/2`` margins against the rollout's growing receptive field.

Layouts are the port's: sequences ``(B, T, C, H, W)``, fields
``(T, C, H, W)``, latents ``(1, 8C, H/32, W/32)``. Everything runs where the
model lives (the card by default) and needs an eval-mode model. Compute
follows the input's dtype, as in JAX: a bfloat16 batch runs the f32 model in
bf16 (every layer casts its f32 weights at use; the kernels' bf16
variants), and the tilers' ``dtype=torch.bfloat16`` runs the tile forwards
in bf16 and stitches an f32 field. The skill metrics run in float32.
With a ``mesh`` (:mod:`.parallel`) both tilers split the tile batches over
the ranks of its ``data`` axis; rank 0 returns the field, the others ``None``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .metrics import crps_ensemble, csi_counts, ensemble_mean_mse, pooled_crps
from .models.common import DRAWS_NOT_SHARED, draw_latents


def make_generate(
    model,
    num_samples: Optional[int] = None,
    shared_context: bool = False,
    microbatch: Optional[int] = 16,
    space=None,
) -> Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]:
    """Ensemble generation: ``generate(x, generator) -> (S, B, T, C, H, W)``.

    Each of the S samples draws one batch-1 latent from ``generator``, shared
    by every batch element (quirk Q2). ``shared_context=True`` runs the
    conditioning stack once and folds the S samples into the sampler's batch
    (``generate_ensemble``); otherwise each sample is its own forward. Both
    give the same result for the same latents.

    ``microbatch`` caps the conv batch of one forward (``S * chunk`` with
    ``shared_context``, ``chunk`` otherwise), as in JAX (default 16): the
    batch is split into chunks of that many elements (the last may be
    shorter) that all reuse each sample's latent, so the result equals the
    unchunked one and only the peak memory changes. ``None`` runs the whole
    batch at once. The model must be in eval mode. ``x`` is moved to the
    model's device, so a CPU batch runs on the card of a model built with
    the default device. Compute and the result follow ``x.dtype`` (float32,
    or bfloat16 through the kernels' bf16 variants), as in JAX; the latents
    are drawn in float32 and cast to it.

    ``space`` (a :class:`~.parallel.spatial.SpaceLayout`) makes ``x`` this
    rank's stripe of H-sharded fields and the nowcasts its stripes: every
    rank of the space group must pass an equally seeded ``generator``. It
    takes one forward per sample (``shared_context=False``).
    """
    n = num_samples if num_samples is not None else model.num_samples
    if space is not None and shared_context:
        raise ValueError("an H-sharded ensemble runs one forward per sample: "
                         "shared_context=False")
    layout = {} if space is None else {"space": space}
    if microbatch is None:
        cap = None
    else:
        cap = max(1, microbatch // n) if shared_context else microbatch

    def one_chunk(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        if shared_context:
            return model.generate_ensemble(x, n, z=z)
        return torch.stack([model(x, z=z[s : s + 1], **layout) for s in range(n)])

    @torch.inference_mode()
    def generate(x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if space is not None and generator is None:
            raise ValueError(DRAWS_NOT_SHARED)
        x = x.to(next(model.parameters()).device)
        z = draw_latents(model.latent_stack.shape, n, generator, x)
        chunks = [x] if cap is None else x.split(cap)
        return torch.cat([one_chunk(xc, z) for xc in chunks], dim=1)

    return generate


def _eval_model(model, dtype=None) -> torch.device:
    """The device of an eval-mode model; raises on train mode and on a ``dtype`` the kernels lack."""
    if dtype is not None and dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"dtype={dtype}: the port's kernels take float32 or bfloat16"
        )
    if model.training:
        raise ValueError("the model is in train mode; call model.eval() to serve nowcasts")
    return next(model.parameters()).device


def make_skill_metrics(
    model,
    *,
    num_samples: Optional[int] = None,
    thresholds=(1.0, 4.0, 8.0),
    pools=(1, 4, 16),
    return_counts: bool = False,
    dtype: Optional[torch.dtype] = None,
    space=None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Per-batch skill: ``batch_metrics(images, future, generator) -> {name: 0-d tensor}``.

    Draws an S-member ensemble through :func:`make_generate` (one shared
    latent per member, quirk Q2) and computes on the model's device the fair
    CRPS at the grid (``crps``) and at each pool > 1 (``crps_pool{p}``), the
    CSI of the ensemble mean at each threshold (``csi_{t}``) and the
    ensemble-mean MSE (``mse``). ``return_counts=True`` adds the contingency
    counts ``csi_counts`` ``(n_thresholds, 3)``, which a dataset-level CSI
    pools (:func:`evaluate_nowcast`). Batches are ``(B, T, C, H, W)``; the
    forwards run in ``dtype`` (``None``: float32; ``torch.bfloat16`` runs the
    kernels' bf16 variants), the metrics in float32.

    With ``space`` (a :class:`~.parallel.spatial.SpaceLayout`) the batches
    are this rank's stripes of the fields: the ensemble runs through the
    H-sharded forward, each mean is the stripes' means averaged over the
    space group and each CSI comes from the counts summed over it, so every
    rank returns the whole fields' numbers. Each stripe's height must divide
    by the largest pool.
    """
    _eval_model(model, dtype)
    dtype = dtype or torch.float32
    generate = make_generate(model, num_samples=num_samples, space=space)
    thresholds = tuple(float(t) for t in thresholds)
    pools = tuple(int(p) for p in pools if int(p) > 1)

    @torch.inference_mode()
    def batch_metrics(images, future, generator: Optional[torch.Generator] = None):
        samples = generate(torch.as_tensor(images).float().to(dtype), generator).float()
        future = torch.as_tensor(future).to(samples.device)
        mean = samples.float().mean(dim=0)
        out = {
            "crps": crps_ensemble(samples, future).mean(),
            "mse": ensemble_mean_mse(samples, future),
        }
        for p in pools:
            out[f"crps_pool{p}"] = pooled_crps(samples, future, p).mean()
        if space is not None:  # equal stripes: the field's mean is the mean of theirs
            keys = list(out)
            means = space.sum(torch.stack([out[k] for k in keys])) / space.size
            out = dict(zip(keys, means))
        if thresholds:
            counts = csi_counts(mean, future, list(thresholds))
            if space is not None:
                counts = space.sum(counts)
            cs = counts[:, 0] / counts.sum(dim=1).clamp_min(1e-12)
            for i, t in enumerate(thresholds):
                out[f"csi_{t:g}"] = cs[i]
            if return_counts:
                out["csi_counts"] = counts
        return out

    return batch_metrics


def evaluate_nowcast(
    model,
    batches: Iterable[Tuple],
    *,
    num_samples: Optional[int] = None,
    thresholds=(1.0, 4.0, 8.0),
    pools=(1, 4, 16),
    generator: Optional[torch.Generator] = None,
    max_batches: Optional[int] = None,
) -> dict:
    """Paper-style skill evaluation over an iterator of ``(images, future)`` batches.

    CRPS and MSE are averaged over batches; CSI is computed once from the
    contingency counts pooled over the whole iterator (a mean of per-batch
    ratios would be biased). Sums stay on the device and only the final
    scalars leave it. ``generator`` (default: seeded 0) draws every latent,
    batch after batch. Returns floats: ``crps``, ``crps_pool{p}``,
    ``csi_{t}``, ``mse`` and the count ``batches``. The forwards run in
    float32 (the skill loop has no ``dtype``; a bf16 batch is converted).
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    thresholds = tuple(float(t) for t in thresholds)
    batch_metrics = make_skill_metrics(
        model, num_samples=num_samples, thresholds=thresholds, pools=pools,
        return_counts=bool(thresholds),
    )
    sums: Dict[str, torch.Tensor] = {}
    counts = None
    n = 0
    for images, future in batches:
        if max_batches is not None and n >= max_batches:
            break
        m = batch_metrics(images, future, generator)
        c = m.pop("csi_counts", None)
        if c is not None:
            counts = c if counts is None else counts + c
        for k, v in m.items():
            if not k.startswith("csi_"):
                sums[k] = sums[k] + v if k in sums else v
        n += 1
    out = {k: float(v) / max(n, 1) for k, v in sums.items()}
    if counts is not None:
        for i, t in enumerate(thresholds):
            out[f"csi_{t:g}"] = float(counts[i, 0] / counts[i].sum().clamp_min(1e-12))
    out["batches"] = n
    return out


def _tile_starts(full: int, tile: int, stride: int):
    """Start offsets covering [0, full) with a final flush-right tile."""
    if full <= tile:
        return [0]
    starts = list(range(0, full - tile, stride))
    starts.append(full - tile)
    return starts


def stitch_seam_indices(n: int, tile: int, overlap: int, device: bool = True):
    """First-difference boundary indices where the writing tile changes.

    A seam is the boundary between output rows (or columns) ``i`` and
    ``i + 1`` written by different tiles. ``device=True`` gives the
    :func:`tiled_nowcast_device` geometry (uniform ``stride``-wide interiors:
    row ``y``'s writer is ``y // stride``); ``device=False`` the
    :func:`tiled_nowcast` overwrite order (each later tile claims from
    ``start + overlap/2``).
    """
    stride = tile - overlap
    margin = overlap // 2
    if device:
        return [k * stride - 1 for k in range(1, -(-n // stride)) if k * stride < n]
    starts = _tile_starts(max(n, tile), tile, stride)
    return [s + margin - 1 for s in starts[1:] if 0 <= s + margin - 1 < n - 1]


def smooth_test_field(
    t: int, h: int, w: int, c: int = 1, seed: int = 0, n_modes: int = 6
) -> np.ndarray:
    """A smooth radar-like field ``(t, c, h, w)`` of advecting low-frequency sinusoids.

    On a field whose own neighbour-to-neighbour variation is small, a
    stitching artifact stands out as an outlier first difference
    (:func:`seam_discontinuity`). The same draws as the JAX package's.
    """
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w] / float(max(h, w))
    field = np.zeros((t, h, w), np.float64)
    for _ in range(n_modes):
        ky, kx = rng.uniform(1.0, 4.0, 2)
        phase = rng.uniform(0.0, 2.0 * np.pi)
        amp = rng.uniform(0.2, 1.0)
        vy, vx = rng.uniform(-0.05, 0.05, 2)
        for ti in range(t):
            field[ti] += amp * np.sin(
                2.0 * np.pi * (ky * (ys + vy * ti) + kx * (xs + vx * ti)) + phase
            )
    field = 0.5 + 0.25 * field / np.sqrt(n_modes)
    return np.repeat(field[:, None], c, axis=1).astype(np.float32)


def seam_discontinuity(out: np.ndarray, *, tile: int, overlap: int, device: bool = True) -> dict:
    """Stitching artifacts of a tiled nowcast ``(T, C, H, W)``.

    * ``seam_max``: the largest first-difference jump across stitch
      boundaries (both axes), where neighbouring pixels come from different
      tiles;
    * ``bg_p999``: the 99.9th percentile of first differences everywhere else;
    * ``ratio``: ``seam_max / bg_p999``; about 1 means the seams do not
      stand out from the field's own texture.
    """
    h, w = out.shape[-2:]
    seam_vals: list = []
    bg: list = []
    for axis, n in ((2, h), (3, w)):
        d = np.abs(np.diff(np.asarray(out, np.float64), axis=axis))
        mask = np.zeros(n - 1, bool)
        mask[stitch_seam_indices(n, tile, overlap, device=device)] = True
        d_m = np.moveaxis(d, axis, 0)
        seam_vals.append(d_m[mask].max() if mask.any() else 0.0)
        bg.append(d_m[~mask].reshape(-1))
    bg_p999 = float(np.percentile(np.concatenate(bg), 99.9))
    seam_max = float(max(seam_vals))
    return {"seam_max": seam_max, "bg_p999": bg_p999, "ratio": seam_max / max(bg_p999, 1e-30)}


def _tiling(model, tile: int, overlap: int, batch_tiles: int, dtype, mesh) -> torch.device:
    if overlap % 2 or tile % 32 or not 0 <= overlap < tile:
        raise ValueError("overlap must be even and in [0, tile), and tile a multiple of 32")
    if batch_tiles < 1:
        raise ValueError(f"batch_tiles must be at least 1, got {batch_tiles}")
    device = _eval_model(model, dtype)
    if mesh is not None:
        mesh.check_device(device)
    return device


def _data_axis(mesh) -> Tuple[int, int, object]:
    """This rank's index on the mesh's data axis, the axis' size and its group (0, 1, None without)."""
    if mesh is None or mesh.shape["data"] == 1:
        return 0, 1, None
    return mesh.data_rank, mesh.shape["data"], mesh.data_group


def _shared_latent(model, c: int, tile: int, z, generator, device, dtype) -> torch.Tensor:
    """The latent ``(1, 8C, tile/32, tile/32)`` that every tile shares, in the tiles' ``dtype``."""
    if z is None:
        lat = tile // 32
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        like = torch.empty((), device=device, dtype=dtype)
        return draw_latents((8 * c, lat, lat), 1, gen, like)
    return torch.as_tensor(z).to(device=device, dtype=torch.float32).to(dtype)


@torch.inference_mode()
def tiled_nowcast(
    model,
    frames,
    *,
    tile: int = 256,
    overlap: int = 64,
    batch_tiles: int = 8,
    generator: Optional[torch.Generator] = None,
    z: Optional[torch.Tensor] = None,
    dtype: Optional[torch.dtype] = None,
    mesh=None,
) -> Optional[np.ndarray]:
    """Nowcast a radar field of any size by tiles streamed through the host.

    Args:
        model: an eval-mode DGMR or Generator whose forward maps
            ``(N, T_in, C, tile, tile)`` to ``(N, T_out, C, tile, tile)``.
        frames: context frames ``(T_in, C, H, W)``, e.g. MRMS 3500x7000: a
            numpy array or a tensor of any float dtype on any device (taken
            to the host as float32).
        tile: the model's input size (its ``output_shape``).
        overlap: overlap of neighbouring tiles; interior seams crop
            ``overlap/2``, domain edges keep the full tile (the last tile of
            a row or column sits flush right).
        batch_tiles: tiles per forward; the last batch may be shorter.
        generator: draws the shared latent (default: seeded 0); ignored if
            ``z`` is given.
        z: a fixed latent ``(1, 8C, tile/32, tile/32)`` shared by all tiles.
        dtype: the tile forwards' compute dtype: ``None`` / ``torch.float32``,
            or ``torch.bfloat16`` (the serving config: tiles and latent in
            bf16, the kernels' bf16 variants, the stitched field f32).
        mesh: a :class:`~.parallel.Mesh`: every rank passes the same
            arguments and forwards its contiguous share of each batch
            (``batch_tiles`` must be a multiple of the data axis' size), and
            one all-reduce per batch gathers the shares. The forwards are
            those of one rank with ``batch_tiles // n`` tiles a forward, so
            the field is bit-identical to that one-rank run.

    Returns:
        The stitched nowcast ``(T_out, C, H, W)``, float32 numpy in host
        memory; ``None`` on every rank of a mesh but rank 0.
    """
    device = _tiling(model, tile, overlap, batch_tiles, dtype, mesh)
    rank, n_ranks, group = _data_axis(mesh)
    if batch_tiles % n_ranks:
        raise ValueError("batch_tiles must be a multiple of the data axis size")
    share = batch_tiles // n_ranks
    dtype = dtype or torch.float32
    if isinstance(frames, torch.Tensor):  # this tiler streams from the host by design
        frames = frames.detach().to("cpu", torch.float32).numpy()
    else:
        frames = np.asarray(frames, np.float32)
    t_in, c, h, w = frames.shape
    stride, margin = tile - overlap, overlap // 2
    z = _shared_latent(model, c, tile, z, generator, device, dtype)

    ph, pw = max(tile - h, 0), max(tile - w, 0)
    if ph or pw:  # every tile full-size
        frames = np.pad(frames, ((0, 0), (0, 0), (0, ph), (0, pw)), mode="edge")
    full_h, full_w = frames.shape[-2:]
    rows, cols = _tile_starts(full_h, tile, stride), _tile_starts(full_w, tile, stride)
    positions = [(i, j) for i in rows for j in cols]
    out = np.zeros((model.sampler.forecast_steps, c, full_h, full_w), np.float32)
    for start in range(0, len(positions), batch_tiles):
        chunk = positions[start : start + batch_tiles]
        if group is None:
            batch = np.stack([frames[:, :, i : i + tile, j : j + tile] for i, j in chunk])
            preds = model(torch.from_numpy(batch).to(device, dtype), z=z).float().cpu().numpy()
        else:
            preds = _gathered_share(model, frames, chunk, rank * share, share, tile, z, device,
                                    dtype, group)
            if rank:
                continue
        for (i, j), pred in zip(chunk, preds):
            top = 0 if i == 0 else margin
            left = 0 if j == 0 else margin
            bottom = tile if i + tile >= full_h else tile - margin
            right = tile if j + tile >= full_w else tile - margin
            out[:, :, i + top : i + bottom, j + left : j + right] = pred[
                :, :, top:bottom, left:right
            ]
    return out[:, :, :h, :w] if rank == 0 else None


def _gathered_share(model, frames, chunk, first, share, tile, z, device, dtype, group):
    """Forward tiles ``chunk[first:first + share]``; every rank's share of ``chunk``, gathered (host f32).

    One all-reduce (sum) of a zeroed buffer in which each rank wrote its own
    predictions: the shares are disjoint, so no value changes.
    """
    import torch.distributed as dist

    mine = chunk[first : first + share]
    t_out, c = model.sampler.forecast_steps, frames.shape[1]
    buf = torch.zeros((len(chunk), t_out, c, tile, tile), dtype=torch.float32, device=device)
    if mine:
        batch = np.stack([frames[:, :, i : i + tile, j : j + tile] for i, j in mine])
        buf[first : first + len(mine)] = model(torch.from_numpy(batch).to(device, dtype), z=z)
    dist.all_reduce(buf, group=group)
    return buf.cpu().numpy()


@torch.inference_mode()
def tiled_nowcast_device(
    model,
    frames,
    *,
    tile: int = 256,
    overlap: int = 64,
    batch_tiles: int = 16,
    generator: Optional[torch.Generator] = None,
    z: Optional[torch.Tensor] = None,
    dtype: Optional[torch.dtype] = None,
    fetch_stripes: int = 1,
    mesh=None,
) -> Optional[np.ndarray]:
    """Device-resident tiled nowcast: the field goes to the device once, the result comes back once.

    The field is copied to the model's device and edge-padded there by
    ``overlap/2`` (then up to whole strides), so every tile, edge tiles
    included, crops a uniform ``overlap/2`` margin and its interiors tile
    the domain in ``stride``-wide squares. Tiles are gathered on the device,
    ``batch_tiles`` per forward (the last batch may be shorter), and their
    interiors written into an output buffer on the device. Pixels at least
    ``overlap/2`` from the domain edge are exact per-tile forwards; edge
    pixels see edge-replicated context instead of a flush-right tile
    (:func:`tiled_nowcast`).

    ``fetch_stripes > 1`` splits the tile rows into that many horizontal
    stripes (at most one per tile row). Every batch is enqueued at once, and
    as soon as the batch that completes a stripe is enqueued, that stripe's
    copy to the host is enqueued on a side stream into pinned memory, so it
    runs while the next stripe computes. The tile batches are the same
    whatever the stripe count, so the result is bit-identical to one stripe.
    With ``dtype=torch.bfloat16`` the field lives on the device in bf16 and
    the tile forwards run in bf16; the stitched output buffer is f32. Other
    arguments and the result as for :func:`tiled_nowcast`, except that a
    ``frames`` tensor already on the model's device is cast there (to
    float32, then ``dtype``) and never passes through the host.

    With a ``mesh`` (:class:`~.parallel.Mesh`) every rank passes the same
    arguments, holds the whole field and runs its contiguous block of the
    tile batches (``ceil(batches / n)`` each; the last ranks may run fewer)
    into a zeroed output buffer. The interiors are disjoint, so one
    all-reduce (sum) stitches the field, bit-identical to the one-rank
    result; rank 0 copies it to the host and returns it, the other ranks
    return ``None``. ``fetch_stripes`` must then be 1.
    """
    device = _tiling(model, tile, overlap, batch_tiles, dtype, mesh)
    dtype = dtype or torch.float32
    if fetch_stripes < 1:
        raise ValueError(f"fetch_stripes must be at least 1, got {fetch_stripes}")
    rank, n_ranks, group = _data_axis(mesh)
    if group is not None and fetch_stripes != 1:
        raise ValueError("with a mesh the field is stitched by one all-reduce: fetch_stripes "
                         "must be 1")
    if isinstance(frames, torch.Tensor):  # a field on the card stays there
        field = frames.detach().to(torch.float32).to(device, dtype)
    else:
        field = torch.as_tensor(np.asarray(frames, np.float32)).to(device, dtype)
    t_in, c, h, w = field.shape
    margin, stride = overlap // 2, tile - overlap
    z = _shared_latent(model, c, tile, z, generator, device, dtype)

    def padded(n):  # tiles at `stride` cover the padded extent exactly
        n2 = n + 2 * margin
        return tile if n2 < tile else tile + -(-(n2 - tile) // stride) * stride

    hp, wp = padded(h), padded(w)
    field = F.pad(field, (margin, wp - w - margin, margin, hp - h - margin), mode="replicate")
    # Tile starts in padded coordinates; the interior of the tile at padded
    # (i, j) starts at real (i, j) and is `stride` wide.
    rows = range(0, hp - tile + 1, stride)
    cols = range(0, wp - tile + 1, stride)
    positions = [(i, j) for i in rows for j in cols]
    starts = range(0, len(positions), batch_tiles)
    out = (torch.empty if group is None else torch.zeros)(
        (model.sampler.forecast_steps, c, h, w), dtype=torch.float32, device=device)
    if group is not None:  # this rank's contiguous block of the batches
        per = -(-len(starts) // n_ranks)
        starts = starts[rank * per : (rank + 1) * per]

    cuda = device.type == "cuda"
    host = torch.empty(out.shape, dtype=torch.float32, pin_memory=cuda) if rank == 0 else None
    copier = torch.cuda.Stream(device) if cuda else None
    # Stripe k ends with tile row last[k]: its pixels are final once that row's last tile is.
    last = [s[-1] for s in np.array_split(np.arange(len(rows)), min(fetch_stripes, len(rows)))]
    done_rows = 0  # output rows [0, done_rows) already sent to the host
    for start in starts:
        chunk = positions[start : start + batch_tiles]
        tiles = torch.stack([field[:, :, i : i + tile, j : j + tile] for i, j in chunk])
        preds = model(tiles, z=z)
        for (i, j), pred in zip(chunk, preds):
            n_y, n_x = min(stride, h - i), min(stride, w - j)
            out[:, :, i : i + n_y, j : j + n_x] = pred[
                :, :, margin : margin + n_y, margin : margin + n_x
            ]
        while group is None and last and (start + len(chunk)) >= (last[0] + 1) * len(cols):
            y1 = min(rows[last.pop(0)] + stride, h)
            stripe = slice(done_rows, y1)
            if cuda:  # the side stream waits for this stripe's writes, then copies it
                copier.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(copier):
                    for t in range(out.shape[0]):  # host[t, ci, stripe] is contiguous
                        for ci in range(c):
                            host[t, ci, stripe].copy_(out[t, ci, stripe], non_blocking=True)
            else:
                host[:, :, stripe] = out[:, :, stripe]
            done_rows = y1
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(out, group=group)
        if rank:
            return None
        host.copy_(out)
    if cuda:
        copier.synchronize()
    return host.numpy()
