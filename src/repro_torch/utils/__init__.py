"""Utilities: the analytic FLOP, parameter and byte models."""
