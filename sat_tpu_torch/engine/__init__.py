"""Caption step, training loop, checkpoints and token decoding (mirrors
sat_tpu.engine for the serving and training paths)."""
