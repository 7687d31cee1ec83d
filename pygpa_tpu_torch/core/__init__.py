"""Elementwise maths and Fourier building blocks."""
