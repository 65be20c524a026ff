"""Metrics, the loss, meters and metric logging of the training path."""
