"""Sliding-window inference, Gaussian blending and metrics."""
