"""Caption step, checkpoint loading and token decoding (mirrors
sat_tpu.engine for the serving path)."""
