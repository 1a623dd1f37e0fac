"""Prefix storage tier."""
