"""Serving artifacts: the nowcast as a ``torch.export`` program, for model-free deploy.

Port of ``skillful_nowcasting_tpu/serving.py``. One ``.dgmrx`` file (a zip)
carries what a serving host needs:

* ``program.pt2`` -- the exported program (``torch.export.save``), in which
  the hand-written kernels are the custom ops ``dgmr::convgru_rollout``,
  ``dgmr::gblock_fused`` and ``dgmr::upsample_gblock_fused``;
* ``weights.npz`` -- the generator's parameters and buffers, by position
  (``arr_0``, ``arr_1``, ...), in the order of ``meta["param_names"]``;
* ``meta.json`` -- config, shapes, ensemble size, compute dtype, device type,
  the latent RNG contract and the artifact version.

The weights are *arguments* of the program, not constants: they can be
replaced without a new export, the program stays small, and the loader feeds
them from wherever they live. Spectral norm's ``W / sigma`` is part of the
program, so new weights take effect as they do in JAX's program.

Design: the program is ONE generator forward, ``(x_chunk, z_sample, weights)
-> (b, T, C, H, W)``, exported once with a dynamic batch of 1 to
``microbatch``; :meth:`NowcastServer.generate` loops over the samples and the
batch chunks as ``make_generate``'s per-sample path does. (JAX exports the
whole ensemble as one program; here the rollout is one op, so the graph is
small either way, and the loop keeps the result equal to ``make_generate``.)

The interface is float32 in and float32 out whatever ``compute_dtype`` is;
``compute_dtype=torch.bfloat16`` casts the input inside the program, and
every layer casts its f32 weights at use (the kernels' bf16 variants). The
latents are drawn outside the program, as ``make_generate`` draws them:
``torch.randn`` on ``torch.Generator("cpu").manual_seed(seed)``, float32,
then moved to the device; so one seed gives the same latents on any device,
and ``generate(x, seed)`` equals ``make_generate(model)(x,
torch.Generator().manual_seed(seed))``. An artifact runs on the device type
it was exported for.

Usage::

    save_exported("model.dgmrx", model, batch_size=2)
    # -- serving host: no model code is imported ----------------------------
    server = load_exported("model.dgmrx").place()   # weights onto the card
    forecast = server.generate(x, seed=7)           # (S, B, T, C, H, W) float32

Loading needs torch, numpy and this package's ``ops`` (which registers the
custom ops); it imports no module of ``skillful_nowcasting_tpu_torch.models``.
"""

from __future__ import annotations

import io
import json
import time
import zipfile
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from . import ops  # noqa: F401  (registers the dgmr:: custom ops)

ARTIFACT_VERSION = 1
DESIGN = (
    "per-sample forward: the program maps one batch chunk x (b, T_in, C, H, W), one "
    "latent z (1, 8C, H/32, W/32) and the weights to one sample (b, T, C, H, W); "
    "generate loops over samples and chunks as make_generate does"
)
STACKS = ("conditioning_stack", "latent_stack", "sampler")


def latent_record(num_samples: int, latent_shape) -> dict:
    """The latent RNG contract that ``generate`` implements, as ``meta["latent_rng"]`` records it."""
    return {
        "generator": "torch.Generator('cpu').manual_seed(seed)",
        "draw": "torch.randn",
        "dtype": "float32",
        "shape": [int(num_samples), *map(int, latent_shape)],
    }


def draw_latents(num_samples: int, latent_shape, seed: int) -> torch.Tensor:
    """The artifact's latents for ``seed``: ``(num_samples, *latent_shape)`` float32 on the CPU.

    The draw ``make_generate`` makes from ``torch.Generator().manual_seed(seed)``.
    """
    gen = torch.Generator("cpu").manual_seed(seed)
    return torch.randn((num_samples, *latent_shape), generator=gen)


def _weights(model) -> tuple[list, list]:
    """Names and tensors of the generator's parameters and buffers, in a fixed order."""
    names, tensors = [], []
    for stack in STACKS:
        mod = getattr(model, stack)
        items = [*mod.named_parameters(), *mod.named_buffers()]
        for name, tensor in items:
            if name.endswith("num_batches_tracked"):  # read by no eval forward
                continue
            names.append(f"{stack}.{name}")
            tensors.append(tensor.detach())
    return names, tensors


class _Forward(torch.nn.Module):
    """``(x, z, weights) -> one nowcast sample``, the weights swapped in by name.

    The model is kept out of the module tree, so the exported program owns
    no tensor: every weight enters as an argument.
    """

    def __init__(self, model, names, compute_dtype):
        super().__init__()
        object.__setattr__(self, "model", model)
        self.names = list(names)
        self.compute_dtype = compute_dtype

    def forward(self, x, z, weights):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        y = torch.func.functional_call(self.model, dict(zip(self.names, weights)), (x,), {"z": z})
        return y.float()


def export_nowcast(
    model,
    *,
    batch_size: int,
    input_frames: int = 4,
    height: Optional[int] = None,
    width: Optional[int] = None,
    num_samples: Optional[int] = None,
    microbatch: Optional[int] = 16,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
):
    """Export one generator forward of an eval-mode model to a ``torch.export.ExportedProgram``.

    Returns ``(program, meta, weights)``. ``batch_size`` is the request's
    batch; ``microbatch`` caps one forward's batch (``None``: the whole
    batch), and the program takes any batch from 1 to that cap, so a ragged
    last chunk needs no second program. ``device`` (default: the model's)
    is the device type the artifact serves on. The export seconds are in
    ``meta["export_seconds"]``.
    """
    if model.training:
        raise ValueError("the model is in train mode; call model.eval() before exporting")
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype={compute_dtype}: float32 or bfloat16")
    h = height or model.output_shape
    w = width or model.output_shape
    n = num_samples if num_samples is not None else model.num_samples
    device = torch.device(device) if device is not None else next(model.parameters()).device
    c = model.input_channels
    latent_shape = tuple(model.latent_stack.shape)
    chunk = batch_size if microbatch is None else min(batch_size, microbatch)

    names, tensors = _weights(model)
    tensors = [t.to(device) for t in tensors]
    x = torch.zeros((chunk, input_frames, c, h, w), device=device)
    z = torch.zeros((1, *latent_shape), device=device)
    batch = torch.export.Dim("batch", min=1, max=chunk) if chunk > 1 else None
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(
            _Forward(model, names, compute_dtype), (x, z, tensors),
            dynamic_shapes=({0: batch} if batch is not None else None, None, [None] * len(tensors)),
            strict=False,
        )
    seconds = time.perf_counter() - t0
    # The example inputs hold every weight; saved with the program they would
    # double the artifact beside weights.npz.
    program.example_inputs = None
    meta = {
        "artifact_version": ARTIFACT_VERSION,
        "design": DESIGN,
        "config": dict(getattr(model, "config", {})),
        "num_samples": n,
        "microbatch": microbatch,
        "input_shape": [batch_size, input_frames, c, h, w],
        "output_shape": [n, batch_size, model.sampler.forecast_steps, c, h, w],
        "compute_dtype": None if compute_dtype is None else str(compute_dtype).split(".")[-1],
        "device_type": device.type,
        "param_names": names,
        "latent_rng": latent_record(n, latent_shape),
        "export_seconds": seconds,
    }
    return program, meta, tensors


def save_exported(path: str, model, **kwargs) -> dict:
    """Export and write one ``.dgmrx`` zip artifact. Returns the meta dict."""
    program, meta, weights = export_nowcast(model, **kwargs)
    prog = io.BytesIO()
    torch.export.save(program, prog)
    buf = io.BytesIO()
    np.savez(buf, *[w.cpu().numpy() for w in weights])
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("program.pt2", prog.getvalue())
        zf.writestr("weights.npz", buf.getvalue())
        zf.writestr("meta.json", json.dumps(meta))
    return meta


def _program_latent_shape(call) -> tuple:
    """The latent input's shape as the program declares it (its second placeholder)."""
    placeholders = [n for n in call.graph.nodes if n.op == "placeholder"]
    return tuple(int(d) for d in placeholders[1].meta["val"].shape[1:])


@dataclass
class NowcastServer:
    """A loaded serving artifact: ``generate(x, seed)`` with no model code.

    ``weights`` live wherever the caller put them: on the host after
    :func:`load_exported`; :meth:`place` moves them to the device once.
    """

    call: Callable
    weights: list
    meta: dict
    _latent_shape: Optional[tuple] = field(default=None, repr=False)

    def generate(self, x, seed: int = 0) -> torch.Tensor:
        """The ``(S, B, T, C, H, W)`` float32 ensemble for context ``x`` ``(B, T_in, C, H, W)``.

        ``x`` is a numpy array or a tensor of any float dtype on the host or the
        card; it is cast to float32 on its way to the weights' device.
        """
        device = self.weights[0].device
        want = self.meta["device_type"]
        if device.type != want:
            raise ValueError(
                f"the artifact was exported for device type {want!r} but its weights are on "
                f"{device.type!r}; call place() with a {want!r} device"
            )
        if self._latent_shape is None:
            self._latent_shape = _program_latent_shape(self.call)
        n = self.meta["num_samples"]
        record = latent_record(n, self._latent_shape)
        if self.meta.get("latent_rng") != record:
            raise ValueError(
                f"meta['latent_rng'] = {self.meta.get('latent_rng')} disagrees with the "
                f"program's latent contract {record}"
            )
        if isinstance(x, torch.Tensor):  # any float dtype, on the host or the card
            x = x.detach().to(torch.float32).to(device)
        else:
            x = torch.as_tensor(np.asarray(x, np.float32)).to(device)
        if list(x.shape) != list(self.meta["input_shape"]):
            raise ValueError(f"x has shape {tuple(x.shape)}, the artifact takes "
                             f"{tuple(self.meta['input_shape'])}")
        z = draw_latents(n, self._latent_shape, seed).to(device)
        cap = self.meta["microbatch"] or x.shape[0]
        with torch.inference_mode():
            return torch.cat(
                [torch.stack([self.call(xc, z[s : s + 1], self.weights) for s in range(n)])
                 for xc in x.split(cap)],
                dim=1,
            )

    def place(self, device="cuda") -> "NowcastServer":
        """Move the weights to ``device`` once (default: the card)."""
        self.weights = [w.to(device) for w in self.weights]
        return self


def load_exported(path: str) -> NowcastServer:
    """Load a ``.dgmrx`` artifact; the weights stay on the host until :meth:`NowcastServer.place`."""
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
        npz = np.load(io.BytesIO(zf.read("weights.npz")))
        n = len(meta["param_names"])
        if len(npz.files) != n:
            raise ValueError(f"artifact weight count {len(npz.files)} != {n} recorded names")
        # By positional key, not archive member order: a repacked zip must not
        # permute the program's positional weight arguments.
        weights = [torch.from_numpy(npz[f"arr_{i}"]) for i in range(n)]
        program = torch.export.load(io.BytesIO(zf.read("program.pt2")))
    return NowcastServer(call=program.module(), weights=weights, meta=meta)
