"""The device mesh (port of ``make_mesh`` in
``spark_rapids_tpu/parallel/mesh_shuffle.py``).

A mesh is the list of ``torch.device`` s a query's exchanges span, in
order.  The port installs one whenever ``spark.rapids.shuffle.ici.enabled``
is on, of every visible device of the session's kind, one included: the
JAX package installs a mesh only from two devices up.  On a one-device
mesh an exchange hands its input on unchanged (the all-to-all over one
shard) and a join between two mesh exchanges runs fused, with static
output sizing and the joinProbe kernel (``ops/gpu_exec.py``).  The
all-to-all across several devices is not ported yet: the session refuses a
mesh of more than one device.
"""

from __future__ import annotations

from typing import List

import torch


def make_mesh(device: torch.device) -> List[torch.device]:
    """Every visible device of ``device`` 's kind, in order; a CPU
    session's mesh is its one CPU device."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]
