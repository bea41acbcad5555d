"""Launchers: the serving launcher (``serve``)."""
