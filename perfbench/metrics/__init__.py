"""Metric readers, end-to-end and per-layer, one module per quantity, found by the name before the first dot."""
