"""Analytic model FLOPs for the port's MFU figures."""
