"""Caption step, training loop, checkpoints and train state, token
decoding and BLEU (mirrors sat_tpu.engine for the serving and training
paths)."""
