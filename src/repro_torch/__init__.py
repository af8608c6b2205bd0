"""PyTorch/CUDA port of ``repro``: the paper's ILP-based HLS scheduler with
its design points lowered to hand-written CUDA kernels for NVIDIA Hopper.

``repro_torch.core`` is the compiler (``hls.compile`` -> ``emit_cuda``);
``repro_torch.kernels`` holds the hand-written kernels and their plain
PyTorch versions.  The package imports neither JAX nor ``repro``.
"""
