"""Plain PyTorch oracles for the port's kernels (the correctness ground
truth), written as the JAX package's pure-jnp oracles are."""
from __future__ import annotations


def stencil_pipeline_ref(img, wx, wy):
    """Fused producer-consumer separable stencil chain (the paper's Fig. 1
    pattern): bx = conv_x(img, wx); out = conv_y(bx, wy).
    img: (H, W); wx, wy: (3,).  'valid' padding: out is (H-2, W-2)."""
    bx = sum(img[:, i:img.shape[1] - 2 + i] * wx[i] for i in range(3))
    out = sum(bx[i:img.shape[0] - 2 + i, :] * wy[i] for i in range(3))
    return out
