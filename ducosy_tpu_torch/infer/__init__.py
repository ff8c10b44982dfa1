"""Dual-generator serving engine and volume postprocess (torch)."""
