"""Layers and the hand-written CUDA kernels' wrappers."""
