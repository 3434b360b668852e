"""Runnable benchmark configurations."""
