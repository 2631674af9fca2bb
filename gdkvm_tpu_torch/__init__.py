"""gdkvm_tpu_torch — the PyTorch/CUDA port of ``gdkvm_tpu`` for NVIDIA Hopper.

It imports ``torch`` and never JAX, flax or ``gdkvm_tpu``.  Plain tensor code
is PyTorch; the GDR forward scan, a Pallas kernel in the JAX package, is a
hand-written CUDA kernel here (``csrc/gdr_fwd.cu``, bound in
``ops/gdr_cuda.py``).  The public layouts match the JAX package, which stays
the reference the port is tested against.
"""

__version__ = "0.1.0"
