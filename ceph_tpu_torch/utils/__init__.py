"""Utilities: the deterministic delivery-order schedule explorer."""
