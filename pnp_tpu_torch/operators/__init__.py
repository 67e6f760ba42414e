"""Weak forms as batched element kernels, and the hand-written CUDA kernels."""
