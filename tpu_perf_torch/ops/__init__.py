"""Measurement ops: library-call bodies and the hand-written kernels."""
