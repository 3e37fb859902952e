"""afan_torch — the PyTorch / CUDA port of ``afan`` for NVIDIA Hopper.

It imports ``torch`` and never ``jax`` or anything of ``afan``. Public
functions keep ``afan``'s layouts (NHWC images in [0, 1], xyxy boxes);
modules run NCHW inside. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
