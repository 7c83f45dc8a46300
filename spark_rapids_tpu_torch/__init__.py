"""spark_rapids_tpu_torch: the PyTorch/CUDA port of ``spark_rapids_tpu``.

The JAX package beside this one is the reference; every module here mirrors
its counterpart's path (``ops/tpu_exec.py`` becomes ``ops/gpu_exec.py``, the
``Tpu`` class prefix becomes ``Gpu``) so a reader can find each pair.  This
package imports ``torch`` and never ``jax`` or the JAX package: it keeps its
own copies of the pieces it needs.

Entry points run on CUDA unless the caller passes ``device="cpu"``; without a
CUDA device they raise instead of quietly running on the CPU.  The one
hand-written kernel on the ported path (the k-way segment pack behind the
merge aggregate's concatenation) lives in ``csrc/`` and is built with
``nvcc`` at first use (:mod:`spark_rapids_tpu_torch.kernels.cuda_tier`).
"""

from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch import types

__all__ = ["RapidsConf", "types"]
