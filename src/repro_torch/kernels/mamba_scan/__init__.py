"""Mamba selective scan: ``ops.mamba_scan`` and its plain version."""
