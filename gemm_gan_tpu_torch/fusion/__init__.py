"""Conditioning / fusion modules."""
