"""Batched and distributed window solves (port of esvio_tpu/dist)."""
