"""Chunk orchestration and the plain tensor ops between the kernels."""
