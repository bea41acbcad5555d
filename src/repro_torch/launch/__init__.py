"""Launchers: the serving launcher (``serve``) and the train loop
(``train``)."""
