"""utils — see the JAX module of the same name in esvio_tpu/utils."""
