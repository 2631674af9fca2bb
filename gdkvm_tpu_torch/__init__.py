"""gdkvm_tpu_torch — the PyTorch/CUDA port of ``gdkvm_tpu`` for NVIDIA Hopper.

It imports ``torch`` and never JAX, flax or ``gdkvm_tpu``.  Plain tensor code
is PyTorch; the GDR scan's Pallas kernels in the JAX package, its forward
(with the backward's residuals) and its backward, are hand-written CUDA
kernels here (``csrc/gdr_fwd.cu``, ``csrc/gdr_bwd.cu``, bound with their
autograd in ``ops/gdr_cuda.py``).  It runs streaming inference and
training (``train/loop.py``).  The public layouts match the JAX package,
which stays the reference the port is tested against.
"""

__version__ = "0.1.0"
