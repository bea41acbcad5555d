"""Prefill flash attention: ``ops.flash_prefill`` and its plain version."""
