"""Optimizers: AGD (NeurIPS'23), WeightedSAM (KDD'23), low-bit Adam states,
stable bf16 training and muP.

Parity: dlrover_wuqiong_tpu/optimizers/ (__init__.py:10-16 for the names).
Each optimizer is a factory ``params -> torch.optim.Optimizer`` (the
port's `trainer.train_step.OptimizerFactory`); `StableBF16` is a plain
class around an inner optimizer.
"""

from .agd import AGD, agd
from .bf16_stable import StableBF16, reset_compensation, stable_bf16
from .low_bit import (
    Adam8bit,
    QTensor,
    adamw8bit,
    dequantize_blockwise,
    quantize_blockwise,
)
from .mup import (
    classify_param,
    mup_adam,
    mup_attn_scale,
    mup_init,
    mup_sgd,
    width_mults,
)
from .wsam import make_wsam_train_step, wsam_gradients

#: the JAX names ``scale_by_agd`` / ``scale_by_adam8bit`` are optax
#: transforms; their torch counterparts are the optimizers themselves
scale_by_agd = AGD
scale_by_adam8bit = Adam8bit

__all__ = [
    "agd", "scale_by_agd",
    "adamw8bit", "scale_by_adam8bit",
    "quantize_blockwise", "dequantize_blockwise",
    "make_wsam_train_step", "wsam_gradients",
    "stable_bf16", "reset_compensation",
    "classify_param", "width_mults", "mup_init", "mup_adam", "mup_sgd",
    "mup_attn_scale",
    "AGD", "Adam8bit", "QTensor", "StableBF16",
]
