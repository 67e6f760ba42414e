"""pnp_tpu_torch — the PyTorch + CUDA port of ``pnp_tpu`` for one NVIDIA H100.

``pnp_tpu`` (JAX/XLA/Pallas) stays the reference; this package mirrors its
module names so each counterpart is easy to find, and is held against it by
the ``tests/test_torch_*.py`` parity tests. It imports ``torch`` and never
``jax``: the host-side numpy modules are copies, and
:mod:`pnp_tpu_torch.interop` carries the reference's data across as numpy
arrays.

Idiom: plain functions on tensors, dataclasses of tensors where ``pnp_tpu``
has pytrees, an explicit ``device`` argument from the entry point down, and
Python loops where ``pnp_tpu`` has ``jit``/``while_loop``/``scan``. Dtypes
follow ``pnp_tpu`` under x64: f64 everywhere, f32 where it casts to f32.
The two Pallas kernels are hand-written CUDA C++ (``csrc/``, bound in
:mod:`pnp_tpu_torch.operators.kernels`).

TF32 is switched off for matmuls and convolutions: the counterpart of the
reference's ``precision=HIGHEST`` rule (true-f32 products feed the f32
stage inverses whose refinement needs them).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
