"""Launchers: the LM serving entry point."""
