"""skillful_nowcasting_tpu_torch: the PyTorch/CUDA port of DGMR.

A second package beside the JAX reference ``skillful_nowcasting_tpu``: the
same module paths and class names, in PyTorch idiom (NCHW ``nn.Module``s,
sequences ``(B, T, C, H, W)``, explicit devices and ``torch.Generator``s), with
the reference torch state-dict schema. It imports neither JAX nor the JAX
package.

Ported so far: the eval nowcast path (``inference.make_generate`` ->
``DGMR.forward`` / ``generate_ensemble``) and the GAN training path
(``training.make_train_step`` / ``make_eval_step``, with the discriminators
and train-mode BatchNorm / spectral norm). Both TPU kernels of the eval path
have hand-written CUDA counterparts for Hopper in ``csrc/``, built on first
use; CPU tensors take their plain PyTorch versions, CUDA tensors the kernels.
Train mode runs plain PyTorch, as the JAX package trains without its kernels.
"""

from .dgmr import DGMR
from .models.common import ContextConditioningStack, LatentConditioningStack
from .models.generators import Generator, Sampler

__all__ = [
    "DGMR",
    "ContextConditioningStack",
    "Generator",
    "LatentConditioningStack",
    "Sampler",
]
