"""Paged decode: ``ops.paged_decode``, ``ops.paged_append`` and their plain versions."""
