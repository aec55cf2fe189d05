"""Checkpointing and metric logging for the port's trainer."""
