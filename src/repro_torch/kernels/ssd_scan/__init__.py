"""Mamba2 chunked SSD scan (state-space duality) forward for Hopper."""
