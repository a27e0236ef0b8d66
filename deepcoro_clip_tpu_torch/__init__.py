"""PyTorch/CUDA port of deepcoro_clip_tpu for NVIDIA Hopper.

Mirrors the JAX package's module names (``configs``, ``flagship``,
``ops/*``, ``data/*``, ``models/*``, ``losses/*``, ``train/*``,
``runners/*``, ``projects/*``, ``utils/*``, ``registry``, ``main``,
``serve``) so each module's counterpart is easy to find. The package imports ``torch`` and never
``jax``, ``flax``, ``optax`` or anything of ``deepcoro_clip_tpu``: host
helpers it needs from there are kept as its own copies.

Attention runs in hand-written CUDA kernels (``csrc/*.cu``) for CUDA
tensors and in their plain PyTorch versions for CPU tensors.
"""
