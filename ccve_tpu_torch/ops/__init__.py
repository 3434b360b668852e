"""Relational operators over torch tensors."""
