"""lpopc_tpu_torch — the PyTorch/CUDA port of the lpopc_tpu optimal-control engine.

Same capabilities and module layout as the JAX package ``lpopc_tpu`` (LGR
collocation, exact-AD NLP transcription, a batched primal-dual interior-point
solver with dense condensed-KKT factorizations), written for an NVIDIA Hopper
GPU: plain tensor code is PyTorch, and the batched small-matrix Cholesky and
Cholesky-solve kernels are hand-written CUDA C++ (``csrc/``), compiled with
``nvcc`` at first use.

Conventions:

* Every entry point takes an explicit ``device=`` and ``dtype=``; the default
  dtype is ``torch.float64`` (optimal control wants double precision) and the
  default device is ``"cuda"``. Nothing here silently runs on the CPU: pass
  ``device="cpu"`` to ask for it (the tests do).
* This package imports ``torch``, numpy and the standard library only.
"""

from .core.postprocess import Solution  # noqa: F401
from .core.problem import INF, Linkage, Phase, Problem  # noqa: F401
from .core.solve import SolveOptions, solve  # noqa: F401
from .core.transcribe import NLP, transcribe  # noqa: F401

__version__ = "0.1.0"
