"""Exploration strategies (counterpart: ilswiss_tpu/exploration/)."""
