"""Schedules, seeding and metrics logging: copies of the JAX package's
helpers (whose package imports JAX), each pinned to its original by a test."""
