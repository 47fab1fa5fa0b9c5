"""skillful_nowcasting_tpu_torch: the PyTorch/CUDA port of DGMR.

A second package beside the JAX reference ``skillful_nowcasting_tpu``: the
same module paths and class names, in PyTorch idiom (NCHW ``nn.Module``s,
sequences ``(B, T, C, H, W)``, explicit devices and ``torch.Generator``s), with
the reference torch state-dict schema. It imports neither JAX nor the JAX
package.

Ported so far: the eval nowcast path (``inference.make_generate`` ->
``DGMR.forward`` / ``generate_ensemble``); the serving user's path (every
model class's ``from_pretrained`` / ``save_pretrained`` in the reference
schema, Lightning checkpoints, ``inference.tiled_nowcast`` /
``tiled_nowcast_device`` for fields of any size, and the paper's skill
metrics through ``inference.evaluate_nowcast``); and the GAN training path
(``training.make_train_step`` / ``make_eval_step``, with the discriminators
and train-mode BatchNorm / spectral norm). Both TPU kernels of the eval path
have hand-written CUDA counterparts for Hopper in ``csrc/``, built on first
use; CPU tensors take their plain PyTorch versions, CUDA tensors the kernels.
Train mode runs plain PyTorch, as the JAX package trains without its kernels.
The retraining path (``Trainer``, ``checkpoint``, ``logging_utils``,
``profiling``, ``data`` and the CLI ``python -m skillful_nowcasting_tpu_torch.run``)
fits, checkpoints and resumes a run, with R1, bf16 mixed precision and
per-layer gradient watch in the step.
The serving artifact (``serving.export_nowcast`` / ``save_exported`` /
``load_exported``) is a ``torch.export`` program in which both kernels are
custom ops. Compute follows the input's dtype: bfloat16 inputs run the
kernels' bf16 variants.
"""

import importlib

# Module attribute -> the submodule that defines it. Imported on first use, so
# importing a submodule (say ``serving``, which serves an artifact without
# model code) loads no module of ``models``.
_LAZY = {
    "DGMR": ".dgmr",
    "ContextConditioningStack": ".models.common",
    "LatentConditioningStack": ".models.common",
    "Generator": ".models.generators",
    "Sampler": ".models.generators",
    "Trainer": ".trainer",
    "MetricsLogger": ".logging_utils",
    "CheckpointManager": ".checkpoint",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_LAZY[name], __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
