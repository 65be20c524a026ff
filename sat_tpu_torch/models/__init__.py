"""Encoder, attention, decoder and beam search (mirrors sat_tpu.models)."""
