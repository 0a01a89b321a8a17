"""dlrover_wuqiong_tpu_torch: the PyTorch and CUDA port of dlrover_wuqiong_tpu.

Parity: each module keeps the name of its counterpart in the JAX package
(``dlrover_wuqiong_tpu/<same path>``), which stays the reference.  The port
imports ``torch`` and nothing of JAX or of the JAX package; what it needs
from a JAX-free module there, it keeps as its own copy.

Ported so far, the int8 serving path:

  serving.LocalServer / SlotScheduler   request queue -> slots -> results
  serving.ServingEngine                 slot KV cache, admit, decode windows
  rl.generation.forward_step            the cached GPT decode step
  ops.quantization                      blockwise int8 pair (CUDA kernels
                                        in csrc/int8_blockwise.cu)

behind a master, the serving worker and its control plane:

  serving.ServingWorker                 lease -> decode windows -> results
  serving.__main__                      the worker process (--device)
  agent.master_client.MasterClient      critical / buffered / polling verbs
  master.master.JobMaster               serve queue + RPC server, no journal
  common.comm / serialize / messages    framed-TCP RPC, the JAX wire format
  telemetry.recorder / spans            flight dumps, cross-process traces
  chaos.serve_drain                     SIGKILL a worker mid-traffic

and the one-device training path:

  auto.accelerate.auto_accelerate       model + optimizer -> train step
  trainer.train_step                    TrainState, make_train_step
                                        (accumulation, fused K steps), adamw
  models.gpt.GPT / cross_entropy_loss   GPT-2 as nn.Modules, flax names
  models.llama.Llama                    Llama-3 (RMSNorm, RoPE, SwiGLU,
                                        GQA), flax names, same loss
  models.attention / models.fp8         the flash route, flax's Dense
  ops.remat                             remat "full" per block
  ops.flash_attention                   forward + fused / split backward
                                        (CUDA kernels in
                                        csrc/flash_attention.cu)

shared by both:

  models.gpt.GPTConfig / init_params    GPT-2 configs, seeded flax-layout init
  convert                               flax tree <-> tensors <-> model
  _build                                nvcc -> ctypes, at first use

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU a default-device call raises.  Importing the package starts
no CUDA context.
"""

from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device=None):
    """``torch.device`` for `device`, defaulting to ``cuda``.

    Raises when CUDA is asked for (explicitly or by default) and absent:
    the port never falls back to the CPU on its own.
    """
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
