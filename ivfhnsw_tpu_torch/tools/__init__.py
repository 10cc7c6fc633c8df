"""Measurement tools of the port: ``kernel_lab`` (the scan lab)."""
