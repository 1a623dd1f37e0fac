"""Workload generation."""
