"""Launchers: the party host of a two-process deployment."""
