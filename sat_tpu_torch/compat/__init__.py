"""Carrying sat_tpu's parameters into the port (jax_params.py)."""
