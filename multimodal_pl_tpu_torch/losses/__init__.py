"""Partial-label segmentation, refiner and adversarial losses."""
