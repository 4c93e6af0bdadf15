"""Attention, layers and the hand-written Hopper kernels' bindings."""
