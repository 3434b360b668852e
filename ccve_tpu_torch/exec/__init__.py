"""Executors."""
