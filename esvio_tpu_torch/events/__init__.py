"""events — see the JAX module of the same name in esvio_tpu/events."""
