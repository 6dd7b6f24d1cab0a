"""fast_lio_tpu_torch — the PyTorch/CUDA port of fast_lio_tpu.

The per-scan LIO path of ``fast_lio_tpu`` (IMU propagate + deskew, local-map
slide + prune, voxel downsample, the iterated point-to-plane iEKF update,
map insert) as plain PyTorch functions on tensors, with the kNN search over
the voxel-hash map as a hand-written CUDA kernel for Hopper
(``csrc/knn.cu``, wrapped by ``kernels/knn.py``).  The module layout mirrors
``fast_lio_tpu`` so each function's counterpart is found by name.

The package imports torch and numpy only: no JAX, and nothing of
``fast_lio_tpu`` (whose ``__init__`` imports JAX).  Every entry point runs on
CUDA unless the caller passes ``device="cpu"``; on a CPU tensor each kernel
wrapper runs the kernel's plain PyTorch version instead.

Numerics: f32 stays true f32.  ``torch.backends.cuda.matmul.allow_tf32`` is
left at its default, False (and ``torch.get_float32_matmul_precision()`` at
"highest"), so the filter's small matmuls and solves never round through
TF32 — the counterpart of the JAX package keeping meter-scale coordinates
out of bf16 matmuls.  The port runs no convolutions, so cuDNN's TF32 switch
does not apply.
"""

__version__ = "0.1.0"
