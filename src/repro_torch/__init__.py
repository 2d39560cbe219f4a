"""PyTorch + CUDA port of the `repro` package, for one NVIDIA H100.

Mirrors `src/repro/` module for module (`repro_torch.core.scaleout` is the
counterpart of `repro.core.scaleout`, and so on). It imports torch and numpy,
never JAX and nothing of `repro`: the JAX package is the reference the port
is held against, bit for bit on the integer HDC algebra and within a stated
tolerance on the float physics.

Entry points take ``device=`` and default to ``"cuda"``; without a CUDA
device they raise unless the caller asked for ``device="cpu"``. The nine
kernels (``kernels/``, one for each Pallas kernel of the reference) are
hand-written CUDA for ``sm_90a``, built with ``nvcc`` at first use; a
kernel wrapper given CPU tensors runs its plain PyTorch twin (``ref.py``)
instead.
"""
