"""PyTorch / CUDA port of tpu-elastic-scheduler's workload plane, for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``elastic_gpu_scheduler_tpu`` is the reference; this
package mirrors its module layout (``models/serving.py``,
``ops/attention.py``, ...) so each counterpart is easy to find.  It imports
``torch``, numpy and the standard library only, never ``jax`` and never a
module of the JAX package.  Every Pallas TPU kernel on a ported path is a
hand-written CUDA kernel here (``csrc/``), built with ``nvcc`` at first use.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``
(the tests do); with no CUDA device and no CPU request they raise.
"""

__version__ = "0.1.0"
