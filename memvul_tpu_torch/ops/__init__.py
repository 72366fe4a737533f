"""Attention and anchor-match operators, each with a hand-written CUDA
kernel for the card and a plain PyTorch version beside it.

The submodules are imported by name (``ops.flash_attention``,
``ops.anchor_match``): each holds its kernel's ``launches`` count."""
