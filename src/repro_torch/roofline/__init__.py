"""Analytical FLOP, byte and roofline models."""
