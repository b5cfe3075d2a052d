"""Timing and tracing of the port on the card."""
