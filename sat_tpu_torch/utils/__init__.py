"""Metrics, the loss, meters, metric logging, corpus BLEU and attention
plots of the training path."""
