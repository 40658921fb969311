"""gliclass.c_tpu_torch — GLiClass zero-shot text classification in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``gliclass.c_tpu`` (JAX/TPU), which stays beside it as the
reference. It imports nothing of JAX and nothing of ``gliclass.c_tpu``: it
reads the same weight bundles, runs the same forward pass and honours the
same batch-job contract (``ZeroShotClassificationPipeline.classify_job``).
Entry points run on the CUDA card unless the caller passes ``device="cpu"``;
on CPU tensors each kernel wrapper runs its plain PyTorch version. The
trainer (``training/``) fine-tunes through the plain formulations. Both run
on one device or, over ``torch.distributed``, with data and tensor
parallelism (``parallel/``).
"""

from .config import BackboneConfig, GLiClassConfig, RuntimeConfig
from .data import ClassificationJob, load_job, parse_job
from .postprocess import LabelScore, TextResult, decide_batch, format_report
from .prompting import pack_prompt, pack_prompts

__version__ = "0.1.0"

__all__ = [
    "BackboneConfig",
    "GLiClassConfig",
    "RuntimeConfig",
    "ClassificationJob",
    "load_job",
    "parse_job",
    "LabelScore",
    "TextResult",
    "decide_batch",
    "format_report",
    "pack_prompt",
    "pack_prompts",
    "__version__",
]
